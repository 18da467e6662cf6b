"""Launcher for the CUDA egress pack kernel (``csrc/staging_pack.cu``), the
Hopper counterpart of ``repro/kernels/staging_pack/kernel.py``.

The kernel re-tiles a row-major (R, C) float32, bfloat16 or float16 array
into block-major (n_blocks, TR*TC) and, for an int8 output, quantizes each
block with its own f32 scale; other outputs (float32, bfloat16) are a cast
with scales 1. The input may hold fewer than R*C elements: the missing tail
counts as zeros, so a caller never pads on the card. It takes
R % TR == C % TC == 0 and TC % 4 == 0, and raises on anything else: there
is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, build, note_cost
from repro_torch.kernels.staging_pack.cost import pack_cost

_IN = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 3}
_OUT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_VEC = 4           # elements a thread moves at a time (csrc kVec)
_MAX_BLOCK = 1 << 30
_MAX_GRID = (1 << 31) - 1


def _library() -> ctypes.CDLL:
    lib = build.load("staging_pack")
    fn = lib.repro_staging_pack
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_int64]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_inputs(x: torch.Tensor, tile: tuple[int, int], out_dtype: torch.dtype,
                 shape: tuple[int, int]) -> None:
    """Raise ValueError on inputs the kernel does not take."""
    R, C = shape
    TR, TC = tile
    if x.dtype not in _IN:
        raise ValueError(f"input dtype {x.dtype} not in {list(_IN)}")
    if out_dtype not in _OUT:
        raise ValueError(f"out_dtype {out_dtype} not in {list(_OUT)}")
    if not x.is_contiguous():
        raise ValueError("the input must be contiguous")
    if TR <= 0 or TC <= 0 or R < 0 or C <= 0 or R % TR or C % TC:
        raise ValueError(f"shape {shape} is not a whole number of {tile} tiles")
    if TC % _VEC:
        raise ValueError(f"tile width {TC} is not a multiple of {_VEC}")
    if TR * TC > _MAX_BLOCK or (R // TR) * (C // TC) > _MAX_GRID:
        raise ValueError(f"{shape} in {tile} tiles is too large")
    if x.numel() > R * C:
        raise ValueError(f"{x.numel()} elements do not fit {shape}")


def pack_blocks(x: torch.Tensor, *, tile: tuple[int, int] = (256, 128),
                out_dtype: Optional[torch.dtype] = None,
                shape: Optional[tuple[int, int]] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream. x is (R, C), or with
    ``shape=(R, C)`` any contiguous tensor whose elements are the first of
    that row-major array (the rest read as 0). Returns (blocks
    (n_blocks, TR*TC) out_dtype, scales (n_blocks,) f32); out_dtype int8
    quantizes. Does not synchronise; raises if the launch is refused.
    Counts each launch in ``LAUNCHES``."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError("the CUDA kernel needs its input on a CUDA device")
    out_dtype = out_dtype or x.dtype
    if shape is None:
        if x.dim() != 2:
            raise ValueError(f"want x (R, C); got {tuple(x.shape)}")
        shape = (x.shape[0], x.shape[1])
    check_inputs(x, tile, out_dtype, shape)
    R, C = shape
    TR, TC = tile
    nb = (R // TR) * (C // TC)
    blocks = torch.empty((nb, TR * TC), dtype=out_dtype, device=x.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if nb == 0:
        return blocks, scales
    cost = (pack_cost, x, blocks, scales)
    if x.device.type == "meta":          # the dry run: shapes and cost only
        note_cost("staging_pack", *cost)
        return blocks, scales
    vec_ok = int(x.data_ptr() % (_VEC * x.element_size()) == 0)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_staging_pack(
            x.data_ptr(), blocks.data_ptr(), scales.data_ptr(), R, C, TR, TC,
            x.numel(), _IN[x.dtype], _OUT[out_dtype], vec_ok, stream)
    build.check(lib, err, "staging_pack launch")
    LAUNCHES["staging_pack"] += 1
    note_cost("staging_pack", *cost)
    return blocks, scales
