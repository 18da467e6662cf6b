"""Plain PyTorch version of the egress pack kernel, the port of
``repro/kernels/staging_pack/ref.py``: block-major re-tiling with an
optional per-block symmetric int8 quantize, computed in f32, with the host
codec's rule for a block whose scale underflows (see ``pack_blocks_ref``)."""
from __future__ import annotations

from typing import Optional

import torch


def pack_blocks_ref(x: torch.Tensor, *, tile: tuple[int, int] = (256, 128),
                    out_dtype: Optional[torch.dtype] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (R, C) with R % TR == C % TC == 0. Returns (blocks (n_blocks, TR*TC)
    out_dtype, scales (n_blocks,) f32), block n = i*(C/TC) + j."""
    R, C = x.shape
    TR, TC = tile
    if R % TR or C % TC:
        raise ValueError(f"shape {(R, C)} is not a whole number of {tile} tiles")
    ni, nj = R // TR, C // TC
    out_dtype = out_dtype or x.dtype
    t = x.reshape(ni, TR, nj, TC).permute(0, 2, 1, 3).reshape(ni * nj, TR * TC)
    if out_dtype == torch.int8:
        t32 = t.to(torch.float32)
        amax = t32.abs().amax(dim=1)
        # a tensor divided by a Python scalar may run on the card as a
        # multiply by the reciprocal, one ulp off the true quotient: divide
        # by a tensor so that both divisions are IEEE ones everywhere
        scale = amax / torch.full_like(amax, 127.0)
        # 1 where amax / 127 is 0: the host codec's rule. The reference's
        # ref.py tests amax > 0, which with IEEE subnormals differs only where
        # amax < 127 * 2^-150 and the quotient underflows: scale 0 there, and
        # 0/0 is NaN
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(t32 / scale[:, None]), -127, 127)
        return q.to(torch.int8), scale
    return t.to(out_dtype), torch.ones(ni * nj, dtype=torch.float32,
                                       device=x.device)


def unpack_blocks_ref(blocks: torch.Tensor, scales: torch.Tensor,
                      shape: tuple[int, int],
                      tile: tuple[int, int] = (256, 128),
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``pack_blocks_ref``: (R, C) in ``dtype``, int8 blocks
    scaled back by their scales."""
    R, C = shape
    TR, TC = tile
    ni, nj = R // TR, C // TC
    t = blocks.to(torch.float32)
    if blocks.dtype == torch.int8:
        t = t * scales[:, None]
    return (t.reshape(ni, nj, TR, TC).permute(0, 2, 1, 3)
            .reshape(R, C).to(dtype))
