"""Launcher for the CUDA flash-attention kernel (``csrc/flash_attention.cu``),
the Hopper counterpart of ``repro/kernels/flash_attention/kernel.py``.

The kernel reads q (B, Sq, Hq, D) and k/v (B, Sk, Hkv, D) in place through
their strides (the head dim must be contiguous) and writes a new
(B, Sq, Hq, D) tensor. It takes float32 and bfloat16 and head dims
16, 32, 64, 128 and 256, and raises on anything else: there is no fallback.
bfloat16 at head dim 64, 128 or 256 runs the tensor-core instance, which
loads through TMA: there each of q, k, v must start on a 16-byte boundary
and every stride of a dimension longer than 1 must be a multiple of 16
bytes (``check_inputs`` raises otherwise; nothing is copied). Besides the
causal mask and the sliding window it takes a prefix-LM ``prefix`` (every
row also sees the keys before it), never together with a window: the
reference model never composes the two, and the kernel does not.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build, note_cost
from repro_torch.kernels.flash_attention.cost import flash_cost

HEAD_DIMS = (16, 32, 64, 128, 256)
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)   # bf16 only
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TMA_ALIGN = 16
_MAX_GRID_Y = 65535


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def launch_shape(D: int, dtype: torch.dtype) -> dict:
    """The dynamic shared memory a block (bytes) and the blocks an SM holds
    at once (CUDA's occupancy calculator) of the instance a (dtype, D) input
    runs: the tensor-core instance for bf16 at D 64, 128, 256, else the FMA
    instance. Needs the card."""
    if dtype not in _DTYPES or D not in HEAD_DIMS:
        raise ValueError(f"no instance for {dtype} at head dim {D}")
    lib = _library()
    fn = lib.repro_flash_attention_launch_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    build.check(lib, fn(D, _DTYPES[dtype], ctypes.byref(smem),
                        ctypes.byref(blocks)), "flash_attention launch_shape")
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def _strides(t: torch.Tensor) -> tuple[int, ...]:
    """Element strides of (B, S, H); a dimension of length 1 is never
    stepped, so its stride is given as if the tensor were contiguous."""
    out, inner = [], t.shape[-1]
    for i in (2, 1, 0):
        out.append(t.stride(i) if t.shape[i] > 1 else inner)
        inner *= t.shape[i]
    return tuple(reversed(out))


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int, prefix: int = 0) -> None:
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
    if q.dtype == torch.bfloat16 and D in TENSOR_CORE_HEAD_DIMS:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % _TMA_ALIGN or any(
                    s * t.element_size() % _TMA_ALIGN for s in _strides(t)):
                raise ValueError(
                    f"{name} (strides {t.stride()}, address {t.data_ptr():#x}) "
                    f"breaks TMA's rule: the address and every stride of a "
                    f"dimension longer than 1 a multiple of {_TMA_ALIGN} bytes")
    if B * Hq > _MAX_GRID_Y:
        raise ValueError(f"B*Hq = {B * Hq} exceeds {_MAX_GRID_Y}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if prefix < 0:
        raise ValueError(f"prefix {prefix} < 0")
    if prefix and window:
        raise ValueError(f"prefix {prefix} with window {window}: the reference "
                         f"gives local layers no prefix, and neither the "
                         f"kernel nor its plain version composes the two")
    # every query row must see at least one key; the dense reference's answer
    # for a row with none (a uniform average) is not reproduced
    if Sq and (Sk == 0 or (window and Sq - 1 > Sk + window - 2)):
        raise ValueError(f"some query rows see no key (Sq={Sq}, Sk={Sk}, "
                         f"causal={causal}, window={window})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, softcap: float = 0.0, causal: bool = True,
                    window: int = 0, prefix: int = 0) -> torch.Tensor:
    """Launch the kernel on the current stream. q: (B,Sq,Hq,D) CUDA;
    k/v: (B,Sk,Hkv,D). Returns (B,Sq,Hq,D) in q's dtype. Does not
    synchronise; raises if the launch is refused. Counts each launch in
    ``LAUNCHES``."""
    if q.device.type not in ("cuda", "meta") or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"the CUDA kernel needs q, k, v on one CUDA device; "
                         f"got {q.device}, {k.device}, {v.device}")
    check_inputs(q, k, v, causal=causal, window=window, prefix=prefix)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if Sq == 0:
        return o
    cost = (flash_cost, B, Sq, Sk, Hq, Hkv, D, q.element_size(), causal,
            window, prefix)
    if q.device.type == "meta":          # the dry run: shapes and cost only
        note_cost("flash_attention", *cost)
        return o
    lib = _library()
    strides = (ctypes.c_int64 * 12)(*[s for t in (q, k, v, o)
                                      for s in _strides(t)])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            B, Sq, Sk, Hq, Hkv, D, _DTYPES[q.dtype], float(scale),
            float(softcap), int(bool(causal)), int(window), int(prefix),
            stream)
    build.check(lib, err, "flash_attention launch")
    LAUNCHES["flash_attention"] += 1
    note_cost("flash_attention", *cost)
    return o
