"""Public wrapper: the mamba-1 selective scan, the port of
``repro/kernels/ssm_scan/ops.py``.

A CUDA tensor goes to the hand-written kernel and a CPU tensor to the plain
version; nothing else chooses between them, and a failed build or launch
raises. Unlike the reference's wrapper, nothing is padded: no tile has to
divide S or di.

On the card the kernel runs inside an ``autograd.Function``
(``SelectiveScan``). Its forward is the kernel; its backward recomputes
through the plain version and differentiates that. This is what the
reference trains with: it has no backward kernel and differentiates its
chunked ``lax.scan`` under ``jax.checkpoint``. The forward never gives way
to the plain version.

A meta tensor (the dry run) takes the same path and launches nothing: the
forward returns the outputs' shapes and notes the kernel's cost, and the
backward returns the gradients' shapes and counts the plain recompute by
its trip count, one and two time steps counted and the rest multiplied
out (``launch.op_analysis``), not run step by step.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ssm_scan import kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

# the plain version's autograd graph keeps about this many (B, di, N) f32
# tensors a time step; the backward recomputes at most RECOMPUTE_BYTES of
# them at once, chunk by chunk over S where the whole sequence's is larger
GRAPH_STATES_A_STEP = 6
RECOMPUTE_BYTES = 2 << 30


def selective_scan(xi: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor,
                   h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xi, dt: (B,S,di); Bm, Cm: (B,S,N); A: (di,N); h0: (B,di,N).
    Returns (y (B,S,di) in xi's dtype, h_last (B,di,N) f32)."""
    if xi.device.type == "cpu":
        return ssm_scan_ref(xi, dt, Bm, Cm, A, h0)
    if xi.device.type in ("cuda", "meta"):
        return SelectiveScan.apply(xi, dt, Bm, Cm, A, h0)
    raise ValueError(f"selective_scan runs on cpu, cuda or meta, not {xi.device}")


def recompute_chunk(B: int, di: int, N: int) -> int:
    """Time steps the backward recomputes under autograd at once."""
    per_step = GRAPH_STATES_A_STEP * B * di * N * 4
    return max(1, RECOMPUTE_BYTES // max(per_step, 1))


class SelectiveScan(torch.autograd.Function):
    """The kernel forward, the plain version's recomputed gradient backward.
    Saves the inputs, not ``y``. ``apply(xi, dt, Bm, Cm, A, h0)``."""

    @staticmethod
    def forward(ctx, xi, dt, Bm, Cm, A, h0):
        ctx.save_for_backward(xi, dt, Bm, Cm, A, h0)
        return kernel.ssm_scan(xi, dt, Bm, Cm, A, h0)

    @staticmethod
    def backward(ctx, dy, dh):
        return scan_vjp(*ctx.saved_tensors, dy, dh,
                        needs=ctx.needs_input_grad)


def scan_vjp(xi, dt, Bm, Cm, A, h0, dy, dh, needs=(True,) * 6,
             chunk: int = 0):
    """The gradients of ``ssm_scan_ref`` at these inputs for the output
    cotangents ``dy`` and ``dh`` (either may be None), one per input (None
    where ``needs`` says none is wanted). The recompute runs ``chunk`` time
    steps at a time (default ``recompute_chunk``), last chunk first: each
    chunk starts from its state, which a pass without autograd computes
    first, and hands the gradient of that state to the chunk before it.
    With one chunk this is autograd through the plain version, op for op.

    On meta nothing runs step by step: each no-grad pass and each chunk's
    recompute is counted at one and two time steps (``_counted``) and
    added as the constant part plus its length times the per-step part,
    with the chunk's working set as a transient peak; its gradients are
    shapes."""
    B, S, di = xi.shape
    chunk = min(chunk or recompute_chunk(B, di, A.shape[1]), max(S, 1))
    bounds = [(a, min(a + chunk, S)) for a in range(0, S, chunk)] or [(0, 0)]
    meta = xi.device.type == "meta"
    starts = [h0]
    with torch.no_grad():
        for a, b in bounds[:-1]:
            ins = [xi[:, a:b], dt[:, a:b], Bm[:, a:b], Cm[:, a:b], A, starts[-1]]
            starts.append(
                _counted(_no_grad_pass, lambda n: _cut(ins, n), b - a,
                         lambda: torch.empty(h0.shape, dtype=torch.float32,
                                             device=h0.device))
                if meta else _no_grad_pass(*ins))
    if dy is None:
        dy = torch.zeros(xi.shape, dtype=xi.dtype, device=xi.device)
    per_chunk = [[] for _ in range(4)]       # xi, dt, Bm, Cm; last chunk first
    dA, carry = None, dh
    for i in reversed(range(len(bounds))):
        a, b = bounds[i]
        ins = [xi[:, a:b], dt[:, a:b], Bm[:, a:b], Cm[:, a:b], A, starts[i]]
        want = [*needs[:5], needs[5] if i == 0 else True]
        if meta:
            g = _counted(
                _chunk_grads,
                lambda n: (_cut(ins, n), want, _cut([dy[:, a:b]], n)[0], carry),
                b - a,
                lambda: [torch.empty_like(t) if w else None
                         for t, w in zip(ins, want)])
        else:
            g = _chunk_grads(ins, want, dy[:, a:b], carry)
        for k in range(4):
            per_chunk[k].append(g[k])
        if g[4] is not None:
            dA = g[4] if dA is None else dA + g[4]
        carry = g[5]
    seq = [None if not needs[k] else
           per_chunk[k][0] if len(bounds) == 1 else torch.cat(per_chunk[k][::-1], 1)
           for k in range(4)]
    return (*seq, dA, carry if needs[5] else None)


def _no_grad_pass(xi, dt, Bm, Cm, A, h0) -> torch.Tensor:
    """The state after a chunk, without autograd."""
    return ssm_scan_ref(xi, dt, Bm, Cm, A, h0)[1]


def _chunk_grads(ins: list, want: list, dy: torch.Tensor,
                 carry: Optional[torch.Tensor]) -> list:
    """One chunk's recompute: the gradients of its inputs ``ins`` (xi, dt,
    Bm, Cm, A, start state) where ``want`` asks for them (zeros where the
    graph does not reach one), given its output gradients ``dy`` and the
    end state's ``carry`` (or None)."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_(w) for t, w in zip(ins, want)]
        y, h = ssm_scan_ref(*live)
        outs, cots = [y], [dy]
        if carry is not None:
            outs.append(h)
            cots.append(carry)
        got = iter(torch.autograd.grad(
            outs, [t for t, w in zip(live, want) if w], cots,
            allow_unused=True))
    g = [next(got) if w else None for w in want]
    return [torch.zeros_like(t) if w and x is None else x
            for t, w, x in zip(ins, want, g)]


def _counted(fn, args_at, steps: int, make_result):
    """On meta: count ``fn(*args_at(steps))`` from its counts at one, two
    and three time steps (``launch.op_analysis.probe``) and return
    ``make_result()`` (meta tensors of its outputs' shapes, made
    uncounted, then held as its outputs) in its place. Every count is at
    most quadratic in the steps: ops a step, or over the chunk, and the
    plain backward adds each step's gradient of a sliced input into a
    whole-chunk buffer (``select_backward`` and an add), which is
    quadratic in bytes and elementwise flops. So three probes give it
    exactly; the working set is taken as linear from the last two."""
    from repro_torch.launch import op_analysis as oa
    with oa.paused():
        result = make_result()
        args = [args_at(n) for n in (1, 2, 3)]
    if not oa.counting():
        return result
    c1, c2, c3 = (oa.probe(fn, *a) for a in args)
    m = steps - 1
    oa.add_counted({k: c1[k] + m * (c2[k] - c1[k])
                    + m * (m - 1) // 2 * (c3[k] - 2 * c2[k] + c1[k])
                    for k in oa.KEYS})
    oa.note_transient(c3["peak_bytes"]
                      + (steps - 3) * (c3["peak_bytes"] - c2["peak_bytes"]))
    oa.hold(result)
    return result


def _cut(ins: list, n: int) -> list:
    """``ins`` with its (B, S, ...) sequence tensors (the first four: xi,
    dt, Bm, Cm; or a lone dy) as new meta tensors of ``n`` time steps."""
    return [torch.empty((t.shape[0], n, *t.shape[2:]), dtype=t.dtype,
                        device=t.device) if k < 4 else t
            for k, t in enumerate(ins)]
