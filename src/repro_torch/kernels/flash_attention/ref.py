"""Plain PyTorch version of the flash-attention kernel: dense softmax
attention with fp32 scores, the port of ``repro/kernels/flash_attention/ref.py``;
its gradient, recomputed one chunk of rows at a time (the backward of the
kernel's ``autograd.Function``); the per-element limit the CUDA kernel is
held to against it; and the mask probe, an input whose answer is exact.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38
# kernel against the plain version: fp32 sums taken in another order
ATOL = 2e-5
# rounding to nearest bf16 moves a value by at most half a step: 2**-8 of it
BF16_ROUNDING = 2.0 ** -8

# Rows of the flattened (batch*head) axis are processed in chunks so that the
# dense fp32 score tensor stays under this many elements. Rows are
# independent, so the chunking does not change the result.
_MAX_SCORE_ELEMS = 1 << 28


def _check_prefix(window: int, prefix: int) -> None:
    """The reference gives local (windowed) layers no prefix, so neither the
    kernel nor this plain version composes the two."""
    if prefix < 0 or (prefix and window):
        raise ValueError(f"prefix {prefix} with window {window}: a prefix is "
                         f">= 0 and never comes with a window")


def _mask(Sq: int, Sk: int, causal: bool, window: int, prefix: int,
          device: torch.device) -> torch.Tensor:
    """The reference's make_mask_fn: causal and window narrow what a row
    sees, then every row also sees the keys k < prefix."""
    _check_prefix(window, prefix)
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= (qp - kp) < window
    if prefix:
        mask |= kp < prefix
    return mask


def _row_chunk(Sq: int, Sk: int) -> int:
    return max(1, _MAX_SCORE_ELEMS // max(Sq * Sk, 1))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, scale: float, softcap: float) -> torch.Tensor:
    """Dense attention of matching rows (one kv row per q row), in f32."""
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, NEG_INF)
    # the shift cancels in the softmax, so no gradient flows through it (the
    # reference's stop_gradient); differentiating it only adds rounding
    p = torch.exp(s - s.amax(-1, keepdim=True).detach())
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return p @ v.float()


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  groups: int = 1, scale: float = 1.0, softcap: float = 0.0,
                  causal: bool = True, window: int = 0,
                  prefix: int = 0) -> torch.Tensor:
    """q: (BHq, Sq, D); k/v: (BHkv, Sk, D) with BHq = BHkv * groups, head-major.
    Same semantics as the kernel: masked scores are NEG_INF and the row sum
    is floored at 1e-30. ``prefix`` (never with a window): every row also
    sees the keys k < prefix. Returns (BHq, Sq, D) in q's dtype."""
    BH, Sq, _ = q.shape
    Sk = k.shape[1]
    mask = _mask(Sq, Sk, causal, window, prefix, q.device)
    out = torch.empty_like(q)
    rows = _row_chunk(Sq, Sk)
    for r0 in range(0, BH, rows):
        r1 = min(r0 + rows, BH)
        kv_rows = torch.arange(r0, r1, device=q.device) // groups
        out[r0:r1] = _attend(q[r0:r1], k[kv_rows], v[kv_rows], mask, scale,
                             softcap).to(q.dtype)
    return out


def attention_ref_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, *, groups: int = 1, scale: float = 1.0,
                      softcap: float = 0.0, causal: bool = True,
                      window: int = 0, prefix: int = 0):
    """The gradients (dq, dk, dv) of ``attention_ref`` at (q, k, v) against
    the output gradient ``do``, each in its input's dtype: the plain version
    recomputed and differentiated one chunk of rows at a time, so that only
    one chunk's scores and probabilities are alive at once (differentiating
    ``attention_ref`` whole keeps every chunk's). dk and dv sum the
    contributions of a kv row's ``groups`` query rows in f32."""
    BH, Sq, _ = q.shape
    Sk = k.shape[1]
    mask = _mask(Sq, Sk, causal, window, prefix, q.device)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    rows = _row_chunk(Sq, Sk)
    for r0 in range(0, BH, rows):
        r1 = min(r0 + rows, BH)
        kv_rows = torch.arange(r0, r1, device=q.device) // groups
        with torch.enable_grad():
            qc = q[r0:r1].detach().requires_grad_()
            kc = k[kv_rows].detach().requires_grad_()
            vc = v[kv_rows].detach().requires_grad_()
            o = _attend(qc, kc, vc, mask, scale, softcap).to(q.dtype)
            gq, gk, gv = torch.autograd.grad(o, (qc, kc, vc), do[r0:r1])
        dq[r0:r1] = gq
        dk.index_add_(0, kv_rows, gk.float())
        dv.index_add_(0, kv_rows, gv.float())
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def kernel_error_limit(o_ref: torch.Tensor, pv_abs: torch.Tensor | None = None,
                       *, dtype: torch.dtype) -> torch.Tensor:
    """How far, element by element, the CUDA kernel's output in ``dtype`` may
    lie from ``o_ref``, the plain version run in f32 on the same input values.

    float32: ATOL. The kernel runs fp32 FMAs; only the order of the sums
    differs.

    bfloat16: 2**-8 * |o_ref| + 2**-8 * pv_abs + ATOL, where ``pv_abs`` is
    the plain version run on |v| (the softmax weights P applied to |V|).
    The tensor-core kernel rounds each probability p to bf16 before P V:
    half a bf16 step, at most 2**-8 of p, so the output moves by at most
    2**-8 * pv_abs (much less where the roundings of different p cancel);
    it rounds its output to bf16, at most 2**-8 * |o|. ATOL covers the f32
    sums and exp, which are ~1e-6 of the values. The second term does not
    shrink where o is near 0, so it is needed whenever p is not exact in
    bf16. (The reference's own bf16 limit is atol 2e-2.)

    ``pv_abs=None`` gives the tight limit 2**-8 * |o_ref| + ATOL, for inputs
    where every p is exact in bf16, as in the mask probe."""
    if dtype == torch.float32:
        return torch.full_like(o_ref, ATOL)
    if dtype != torch.bfloat16:
        raise ValueError(f"no limit for {dtype}")
    lim = BF16_ROUNDING * o_ref.abs() + ATOL
    if pv_abs is not None:
        lim = lim + BF16_ROUNDING * pv_abs
    return lim


def mask_probe(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int, *,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cpu"):
    """q = 0 and v[b, k, h, :] = (-1)**k in (B, S, H, D) layout. Every score
    is 0 and every p is exactly 1 in any precision, so each output row is the
    mean of (-1)**k over its visible keys: exact, and one key too many or
    too few changes it by at least 1 / (visible keys + 1)."""
    q = torch.zeros((B, Sq, Hq, D), dtype=dtype, device=device)
    k = torch.zeros((B, Sk, Hkv, D), dtype=dtype, device=device)
    sign = 1.0 - 2.0 * (torch.arange(Sk, device=device) % 2).to(dtype)
    v = sign[None, :, None, None].expand(B, Sk, Hkv, D).contiguous()
    return q, k, v


def mask_probe_answer(B: int, Sq: int, Sk: int, Hq: int, D: int, *,
                      causal: bool, window: int, prefix: int = 0,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """The probe's exact output (B, Sq, Hq, D) in f32: each row sees the keys
    lo..hi, whose (-1)**k sum to 0 when their count n is even and to
    (-1)**lo when it is odd. A prefix (no window) raises hi to at least
    prefix - 1."""
    _check_prefix(window, prefix)
    qp = torch.arange(Sq, device=device)
    hi = (torch.clamp(torch.clamp(qp, min=prefix - 1), max=Sk - 1) if causal
          else torch.full_like(qp, Sk - 1))
    lo = torch.clamp(qp - window + 1, min=0) if window else torch.zeros_like(qp)
    n = (hi - lo + 1).to(torch.float64)
    odd = (hi - lo + 1) % 2 == 1
    row = torch.where(odd, (1.0 - 2.0 * (lo % 2)).to(torch.float64) / n,
                      torch.zeros_like(n)).to(torch.float32)
    return row[None, :, None, None].expand(B, Sq, Hq, D)
