"""Public wrapper: any-shape tensors to contiguous egress blocks, the port
of ``repro/kernels/staging_pack/ops.py`` (without its ``impl`` and
``interpret`` switches).

A CUDA tensor goes to the hand-written kernel and a CPU tensor to the plain
version; nothing else chooses between them, and a failed build or launch
raises. On the card nothing is padded: the kernel reads the missing tail of
the last block as zeros. Block size in *bytes* is the paper's knob;
``tile_for_block`` turns it into the reference's tile, a layout contract
that ``unpack`` and staging read, not a GPU tile choice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.blocks import vmem_tile
from repro_torch.kernels.staging_pack import kernel, ref


def tile_for_block(block_bytes: int, dtype: torch.dtype) -> tuple[int, int]:
    return vmem_tile(block_bytes // dtype.itemsize, dtype.itemsize)


def pack_flat(flat: torch.Tensor, shape: tuple[int, int],
              tile: tuple[int, int], out_dtype: torch.dtype
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack the row-major (R, C) array whose first elements are ``flat``
    (contiguous, at most R*C of them) and whose tail is zeros."""
    if flat.device.type in ("cuda", "meta"):   # meta: shapes, no launch
        return kernel.pack_blocks(flat, tile=tile, out_dtype=out_dtype,
                                  shape=shape)
    if flat.device.type != "cpu":
        raise ValueError(f"staging_pack runs on cpu, cuda or meta, not {flat.device}")
    pad = shape[0] * shape[1] - flat.numel()
    x2 = torch.nn.functional.pad(flat, (0, pad)).reshape(shape)
    return ref.pack_blocks_ref(x2, tile=tile, out_dtype=out_dtype)


def pack(x: torch.Tensor, *, block_bytes: int = 4 << 20,
         out_dtype: Optional[torch.dtype] = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack any-shape tensor into (n_blocks, block_elems) + scales."""
    out_dtype = out_dtype or x.dtype
    tr, tc = tile_for_block(block_bytes, out_dtype)
    flat = x.reshape(-1)
    rows = math.ceil(flat.numel() / tc)
    rows += (-rows) % tr
    return pack_flat(flat, (rows, tc), (tr, tc), out_dtype)


def unpack(blocks: torch.Tensor, scales: torch.Tensor, shape: tuple[int, ...],
           *, block_bytes: int = 4 << 20,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of pack (host/analysis side). The lane width comes from
    ``tile_for_block`` on the packed dtype, as pack computed it; rows per
    block come from the packed shape, whatever ``block_bytes`` pack had."""
    _, tc = tile_for_block(block_bytes, blocks.dtype)
    if blocks.shape[1] % tc:
        raise ValueError(
            f"blocks have {blocks.shape[1]} elems/block, not a multiple "
            f"of the {tc}-lane tile width for dtype {blocks.dtype}")
    tr = blocks.shape[1] // tc
    n = math.prod(shape)
    rows = -(-n // tc)
    rows += (-rows) % tr
    full = ref.unpack_blocks_ref(blocks, scales, (rows, tc), (tr, tc), dtype)
    return full.reshape(-1)[:n].reshape(shape)


def quantize_blocks(x: torch.Tensor, *, block_elems: int = 4096
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Egress-codec quantizing variant: (n_blocks, block_elems) int8 plus
    one f32 amax/127 scale per block of ``block_elems`` consecutive flat
    elements, the last block zero-filled; the int8-block codec's host
    layout, so the device->host copy moves int8 + scales."""
    if block_elems % 128:
        raise ValueError(f"block_elems must be a multiple of 128 lanes, "
                         f"got {block_elems}")
    tc = 128
    tr = block_elems // tc
    n = x.numel()
    if n == 0:
        return (torch.zeros((0, block_elems), dtype=torch.int8, device=x.device),
                torch.zeros((0,), dtype=torch.float32, device=x.device))
    nb = -(-n // block_elems)
    return pack_flat(x.reshape(-1), (nb * tr, tc), (tr, tc), torch.int8)


def dequantize_blocks(blocks: torch.Tensor, scales: torch.Tensor, n: int, *,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_blocks`` (flat, truncated to ``n`` elements)."""
    t = blocks.to(torch.float32) * scales[:, None]
    return t.reshape(-1)[:n].to(dtype)
