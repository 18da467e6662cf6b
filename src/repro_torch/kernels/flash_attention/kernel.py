"""Launcher for the CUDA flash-attention kernel (``csrc/flash_attention.cu``),
the Hopper counterpart of ``repro/kernels/flash_attention/kernel.py``.

The kernel reads q (B, Sq, Hq, D) and k/v (B, Sk, Hkv, D) in place through
their strides (the head dim must be contiguous) and writes a new
(B, Sq, Hq, D) tensor. It takes float32 and bfloat16 and head dims
16, 32, 64 and 128, and raises on anything else: there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int) -> None:
    """Raise ValueError on inputs the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Sq,Hq,D) and k/v (B,Sk,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}: need equal B and D, Hq % Hkv == 0")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         f"takes one of {list(_DTYPES)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim must be contiguous")
    if B * Hq > _MAX_GRID_Y:
        raise ValueError(f"B*Hq = {B * Hq} exceeds {_MAX_GRID_Y}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    # every query row must see at least one key; the dense reference's answer
    # for a row with none (a uniform average) is not reproduced
    if Sq and (Sk == 0 or (window and Sq - 1 > Sk + window - 2)):
        raise ValueError(f"some query rows see no key (Sq={Sq}, Sk={Sk}, "
                         f"causal={causal}, window={window})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, softcap: float = 0.0, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Launch the kernel on the current stream. q: (B,Sq,Hq,D) CUDA;
    k/v: (B,Sk,Hkv,D). Returns (B,Sq,Hq,D) in q's dtype. Does not
    synchronise; raises if the launch is refused. Counts each launch in
    ``LAUNCHES``."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"the CUDA kernel needs q, k, v on one CUDA device; "
                         f"got {q.device}, {k.device}, {v.device}")
    check_inputs(q, k, v, causal=causal, window=window)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if Sq == 0:
        return o
    lib = _library()
    strides = (ctypes.c_int64 * 12)(*[s for t in (q, k, v, o)
                                      for s in t.stride()[:3]])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            B, Sq, Sk, Hq, Hkv, D, _DTYPES[q.dtype], float(scale),
            float(softcap), int(bool(causal)), int(window), stream)
    build.check(lib, err, "flash_attention launch")
    LAUNCHES["flash_attention"] += 1
    return o
