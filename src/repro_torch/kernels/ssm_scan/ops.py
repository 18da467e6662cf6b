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
"""
from __future__ import annotations

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
    if xi.device.type == "cuda":
        return SelectiveScan.apply(xi, dt, Bm, Cm, A, h0)
    raise ValueError(f"selective_scan runs on cpu or cuda, not {xi.device}")


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
    With one chunk this is autograd through the plain version, op for op."""
    B, S, di = xi.shape
    chunk = min(chunk or recompute_chunk(B, di, A.shape[1]), max(S, 1))
    bounds = [(a, min(a + chunk, S)) for a in range(0, S, chunk)] or [(0, 0)]
    starts = [h0]
    with torch.no_grad():
        for a, b in bounds[:-1]:
            starts.append(ssm_scan_ref(xi[:, a:b], dt[:, a:b], Bm[:, a:b],
                                       Cm[:, a:b], A, starts[-1])[1])
    if dy is None:
        dy = torch.zeros(xi.shape, dtype=xi.dtype, device=xi.device)
    per_chunk = [[] for _ in range(4)]       # xi, dt, Bm, Cm; last chunk first
    dA, carry = None, dh
    for i in reversed(range(len(bounds))):
        a, b = bounds[i]
        ins = [xi[:, a:b], dt[:, a:b], Bm[:, a:b], Cm[:, a:b], A, starts[i]]
        want = [*needs[:5], needs[5] if i == 0 else True]
        with torch.enable_grad():
            live = [t.detach().requires_grad_(w) for t, w in zip(ins, want)]
            y, h = ssm_scan_ref(*live)
            outs, cots = [y], [dy[:, a:b]]
            if carry is not None:
                outs.append(h)
                cots.append(carry)
            got = iter(torch.autograd.grad(
                outs, [t for t, w in zip(live, want) if w], cots,
                allow_unused=True))
        g = [next(got) if w else None for w in want]
        g = [torch.zeros_like(t) if w and x is None else x
             for t, w, x in zip(ins, want, g)]
        for k in range(4):
            per_chunk[k].append(g[k])
        if g[4] is not None:
            dA = g[4] if dA is None else dA + g[4]
        carry = g[5]
    seq = [None if not needs[k] else
           per_chunk[k][0] if len(bounds) == 1 else torch.cat(per_chunk[k][::-1], 1)
           for k in range(4)]
    return (*seq, dA, carry if needs[5] else None)
