"""Plain PyTorch version of the selective-scan kernel: the mamba-1
recurrence step by step in fp32, the port of ``repro/kernels/ssm_scan/ref.py``.
"""
from __future__ import annotations

import torch


def ssm_scan_ref(xi: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, A: torch.Tensor,
                 h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(dt_t*A) * h_{t-1} + (dt_t*x_t) B_t ;  y_t = h_t . C_t.

    xi, dt: (B,S,di); Bm, Cm: (B,S,N); A: (di,N); h0: (B,di,N). Returns
    (y (B,S,di) in xi's dtype, h_last (B,di,N) f32). The loop runs over
    time and holds one (B,di,N) state: it never builds a (B,S,di,N) tensor.
    """
    A = A.float()
    dt32 = dt.float()
    dx = dt32 * xi.float()                               # (B,S,di)
    Bf, Cf = Bm.float(), Cm.float()
    h = h0.float().clone()
    y = torch.empty(xi.shape, dtype=xi.dtype, device=xi.device)
    for t in range(xi.shape[1]):
        decay = torch.exp(dt32[:, t, :, None] * A)       # (B,di,N)
        h = decay * h + dx[:, t, :, None] * Bf[:, t, None, :]
        y[:, t] = sum_state(h * Cf[:, t, None, :])
    return y, h


def sum_state(q: torch.Tensor) -> torch.Tensor:
    """Sum over the last (state) axis by halving: q[:half] + q[half:] until
    one is left, the axis first padded with zeros to a power of two. A
    fixed order, which the CUDA kernel follows, so the two agree bit for
    bit."""
    n = q.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        q = torch.nn.functional.pad(q, (0, width - n))
    while q.shape[-1] > 1:
        half = q.shape[-1] // 2
        q = q[..., :half] + q[..., half:]
    return q[..., 0]
