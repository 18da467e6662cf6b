"""Launcher for the CUDA selective-scan kernel (``csrc/ssm_scan.cu``), the
Hopper counterpart of ``repro/kernels/ssm_scan/kernel.py``.

The kernel reads xi, dt (B, S, di) and Bm, Cm (B, S, N) in place through
their batch and sequence strides (the last dim must be contiguous), each in
float32 or bfloat16, and writes a new y (B, S, di) in xi's dtype and
h_last (B, di, N) in float32. A and h0 are taken as contiguous float32
(the wrapper casts them: they are small). It takes 1 <= N <= 16 and raises
on anything else: there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build

MAX_STATE = 16
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def _library() -> ctypes.CDLL:
    lib = build.load("ssm_scan")
    fn = lib.repro_ssm_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_ssm_scan_chunk_steps.argtypes = []
        lib.repro_ssm_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.repro_ssm_scan_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        for f in (lib.repro_ssm_scan_chunk_steps, lib.repro_ssm_scan_smem_bytes,
                  lib.repro_ssm_scan_blocks_per_sm):
            f.restype = ctypes.c_int
    return lib


def chunk_steps() -> int:
    """Time steps the kernel stages in shared memory at once (a chunk)."""
    return _library().repro_ssm_scan_chunk_steps()


def launch_shape(x_dtype: torch.dtype, dt_dtype: torch.dtype,
                 bc_dtype: torch.dtype, full: bool = True) -> dict:
    """The kernel's dynamic shared memory a block (bytes) and the blocks an
    SM holds at once (CUDA's occupancy calculator) for these input dtypes,
    with N == 16 (``full``) or less."""
    lib = _library()
    flags = (_BF16[x_dtype], _BF16[dt_dtype], _BF16[bc_dtype])
    return {"smem_bytes": lib.repro_ssm_scan_smem_bytes(*flags),
            "blocks_per_sm": lib.repro_ssm_scan_blocks_per_sm(*flags, int(full))}


def check_inputs(xi: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor) -> None:
    """Raise ValueError on inputs the kernel does not take."""
    if xi.dim() != 3 or dt.shape != xi.shape:
        raise ValueError(f"want xi, dt (B,S,di); got {tuple(xi.shape)}, "
                         f"{tuple(dt.shape)}")
    B, S, di = xi.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"want A (di={di}, N); got {tuple(A.shape)}")
    N = A.shape[1]
    if Bm.shape != (B, S, N) or Cm.shape != (B, S, N):
        raise ValueError(f"want Bm, Cm {(B, S, N)}; got {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    if h0.shape != (B, di, N):
        raise ValueError(f"want h0 {(B, di, N)}; got {tuple(h0.shape)}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size {N} not in 1..{MAX_STATE}")
    if any(t.dtype not in _BF16 for t in (xi, dt, Bm, Cm)) or Cm.dtype != Bm.dtype:
        raise ValueError(f"dtypes {xi.dtype}/{dt.dtype}/{Bm.dtype}/{Cm.dtype}: "
                         f"each of xi, dt, Bm=Cm must be one of {list(_BF16)}")
    if any(t.stride(-1) != 1 for t in (xi, dt, Bm, Cm)):
        raise ValueError("the last dim of xi, dt, Bm, Cm must be contiguous")
    if B > _MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds {_MAX_GRID_Y}")


def ssm_scan(xi: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, A: torch.Tensor,
             h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream. Returns (y (B,S,di) in xi's
    dtype, h_last (B,di,N) f32). Does not synchronise; raises if the launch
    is refused. Counts each launch in ``LAUNCHES``."""
    dev = xi.device
    if dev.type != "cuda" or any(t.device != dev for t in (dt, Bm, Cm, A, h0)):
        raise ValueError("the CUDA kernel needs every input on one CUDA device")
    check_inputs(xi, dt, Bm, Cm, A, h0)
    B, S, di = xi.shape
    N = A.shape[1]
    A32 = A.to(torch.float32).contiguous()
    h0_32 = h0.to(torch.float32).contiguous()
    if S == 0:
        return xi.new_empty((B, 0, di)), h0_32.clone()
    y = torch.empty((B, S, di), dtype=xi.dtype, device=dev)
    h_last = torch.empty((B, di, N), dtype=torch.float32, device=dev)
    lib = _library()
    strides = (ctypes.c_int64 * 8)(*[s for t in (xi, dt, Bm, Cm)
                                     for s in t.stride()[:2]])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_ssm_scan_fwd(
            xi.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A32.data_ptr(), h0_32.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            strides, B, S, di, N, _BF16[xi.dtype], _BF16[dt.dtype],
            _BF16[Bm.dtype], stream)
    build.check(lib, err, "ssm_scan launch")
    LAUNCHES["ssm_scan"] += 1
    return y, h_last
