"""Public wrapper: the mamba-1 selective scan, the port of
``repro/kernels/ssm_scan/ops.py``.

A CUDA tensor goes to the hand-written kernel and a CPU tensor to the plain
version; nothing else chooses between them, and a failed build or launch
raises. Unlike the reference's wrapper, nothing is padded: no tile has to
divide S or di.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref


def selective_scan(xi: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor,
                   h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xi, dt: (B,S,di); Bm, Cm: (B,S,N); A: (di,N); h0: (B,di,N).
    Returns (y (B,S,di) in xi's dtype, h_last (B,di,N) f32)."""
    if xi.device.type == "cpu":
        return ssm_scan_ref(xi, dt, Bm, Cm, A, h0)
    if xi.device.type == "cuda":
        return kernel.ssm_scan(xi, dt, Bm, Cm, A, h0)
    raise ValueError(f"selective_scan runs on cpu or cuda, not {xi.device}")
