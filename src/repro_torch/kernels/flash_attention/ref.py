"""Plain PyTorch version of the flash-attention kernel: dense softmax
attention with fp32 scores, the port of ``repro/kernels/flash_attention/ref.py``.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38

# Rows of the flattened (batch*head) axis are processed in chunks so that the
# dense fp32 score tensor stays under this many elements. Rows are
# independent, so the chunking does not change the result.
_MAX_SCORE_ELEMS = 1 << 28


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  groups: int = 1, scale: float = 1.0, softcap: float = 0.0,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (BHq, Sq, D); k/v: (BHkv, Sk, D) with BHq = BHkv * groups, head-major.
    Same semantics as the kernel: masked scores are NEG_INF and the row sum
    is floored at 1e-30. Returns (BHq, Sq, D) in q's dtype."""
    BH, Sq, _ = q.shape
    Sk = k.shape[1]
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= (qp - kp) < window
    out = torch.empty_like(q)
    rows = max(1, _MAX_SCORE_ELEMS // max(Sq * Sk, 1))
    for r0 in range(0, BH, rows):
        r1 = min(r0 + rows, BH)
        kv_rows = torch.arange(r0, r1, device=q.device) // groups
        kf, vf = k[kv_rows].float(), v[kv_rows].float()
        s = (q[r0:r1].float() @ kf.transpose(1, 2)) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        out[r0:r1] = (p @ vf).to(q.dtype)
    return out
