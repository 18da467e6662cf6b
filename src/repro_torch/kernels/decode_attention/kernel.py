"""Launcher for the CUDA decode-attention kernel
(``csrc/decode_attention.cu``): one new query token a row against its KV
cache, reading each row's K and V once and only up to the row's position.

The kernel reads q (B, 1, Hq, D), k/v (B, T, Hkv, D) and the slots'
positions (B, T) in place through their strides (the head dim and the slot
axis of the positions must be contiguous) and writes a new (B, 1, Hq, D)
tensor in the caches' dtype, or with ``partial`` the f32 (B, Hkv, G, D + 2)
partial (m, l, o) of one rank of a sequence-sharded cache. It takes float32
and bfloat16 and head dims 16, 32, 64, 128 and 256, and raises on anything
else: there is no fallback. bfloat16 at head dim 64, 128 or 256 runs the
tensor-core instance, which copies K and V 16 bytes at a time: there each
cache must start on a 16-byte boundary with every stride a multiple of 16
bytes, and q on a 4-byte one with even strides (``check_inputs`` raises
otherwise; nothing is copied).

The number of splits of the slot axis (blocks a row and KV head) comes
from the shape alone (``plan``), once a shape.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build, note_cost
from repro_torch.kernels.decode_attention.cost import decode_cost

HEAD_DIMS = (16, 32, 64, 128, 256)
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)   # bf16 only
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POS_DTYPES = (torch.int32, torch.int64)
HEADS_PER_BLOCK = 8       # the query heads a block serves: mma's N
ROUND = 64                # slots a block's 4 warps take at a time
MAX_CHUNK = 8192          # the most slots one block reads
_MAX_GRID_YZ = 65535
_ALIGN = 16

_plans: dict[tuple, tuple[int, int]] = {}


def _library() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        shape = lib.repro_decode_attention_launch_shape
        shape.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
        shape.restype = ctypes.c_int
    return lib


def launch_shape(D: int, dtype: torch.dtype) -> dict:
    """The threads a block, the dynamic shared memory a block (bytes) and
    the blocks an SM holds at once (CUDA's occupancy calculator) of the
    instance a (dtype, D) input runs. Needs the card."""
    if dtype not in _DTYPES or D not in HEAD_DIMS:
        raise ValueError(f"no instance for {dtype} at head dim {D}")
    lib = _library()
    threads, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build.check(lib, lib.repro_decode_attention_launch_shape(
        D, _DTYPES[dtype], ctypes.byref(threads), ctypes.byref(smem),
        ctypes.byref(blocks)), "decode_attention launch_shape")
    return {"threads": threads.value, "smem_bytes": smem.value,
            "blocks_per_sm": blocks.value}


def plan(B: int, T: int, Hkv: int, G: int, n_sm: int,
         blocks_per_sm: int) -> tuple[int, int]:
    """(splits, chunk): the slot axis cut into ``splits`` ranges of
    ``chunk`` slots (a multiple of ``ROUND``), so that the grid holds about
    two waves of blocks (n_sm · blocks_per_sm each) and no block reads
    more than ``MAX_CHUNK`` slots."""
    blocks = B * Hkv * -(-G // HEADS_PER_BLOCK)
    waves = -(-2 * n_sm * max(blocks_per_sm, 1) // blocks)
    splits = min(max(waves, -(-T // MAX_CHUNK)), -(-T // ROUND))
    chunk = -(-T // splits)
    chunk = -(-chunk // ROUND) * ROUND
    return -(-T // chunk), chunk


def _card_plan(device: torch.device, B: int, T: int, Hkv: int, G: int, D: int,
               dtype: torch.dtype) -> tuple[int, int]:
    """``plan`` on this card (its SM count, the instance's blocks an SM),
    computed once a shape."""
    key = (device.index, B, T, Hkv, G, D, dtype)
    got = _plans.get(key)
    if got is None:
        with torch.cuda.device(device):
            n_sm = torch.cuda.get_device_properties(device).multi_processor_count
            got = _plans[key] = plan(B, T, Hkv, G, n_sm,
                                     launch_shape(D, dtype)["blocks_per_sm"])
    return got


def check_inputs(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: torch.Tensor, cache_positions: torch.Tensor, *,
                 cap: float, window: int, seq_index: int = 0) -> None:
    """Raise ValueError on inputs the kernel does not take."""
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"want q (B,1,Hq,D) and k/v caches (B,T,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, S, Hq, D = q.shape
    _, T, Hkv, _ = k_cache.shape
    if S != 1:
        raise ValueError(f"decode takes one query token a row, got {S}")
    if k_cache.shape[0] != B or k_cache.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)}: need equal B and D, "
                         f"Hq % Hkv == 0")
    if T == 0 or B == 0:
        raise ValueError(f"an empty batch or cache: B={B}, T={T}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}: the "
                         f"kernel takes one of {list(_DTYPES)} for all three")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise ValueError("the head dim must be contiguous")
    if pos.shape != (B,) or pos.dtype not in _POS_DTYPES:
        raise ValueError(f"pos must be ({B},) of {_POS_DTYPES}; got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    if cache_positions.shape != (B, T) or cache_positions.dtype != torch.int32:
        raise ValueError(f"cache_positions must be ({B}, {T}) int32; got "
                         f"{tuple(cache_positions.shape)} {cache_positions.dtype}")
    if T > 1 and cache_positions.stride(1) != 1:
        raise ValueError("cache_positions' slot axis must be contiguous")
    if any(t.device != q.device for t in (k_cache, v_cache, pos, cache_positions)):
        raise ValueError(f"all inputs on one device; got {q.device}, "
                         f"{k_cache.device}, {v_cache.device}, {pos.device}, "
                         f"{cache_positions.device}")
    if q.dtype == torch.bfloat16 and D in TENSOR_CORE_HEAD_DIMS:
        for name, t, align in (("q", q, 4), ("k_cache", k_cache, _ALIGN),
                               ("v_cache", v_cache, _ALIGN)):
            steps = [t.stride(i) for i in range(3) if t.shape[i] > 1]
            if t.data_ptr() % align or any(s * t.element_size() % align
                                           for s in steps):
                raise ValueError(
                    f"{name} (strides {t.stride()}, address {t.data_ptr():#x}) "
                    f"breaks the tensor-core instance's rule: the address and "
                    f"every stride of a dimension longer than 1 a multiple of "
                    f"{align} bytes")
    if B > _MAX_GRID_YZ:
        raise ValueError(f"B = {B} exceeds {_MAX_GRID_YZ}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if cap < 0:
        raise ValueError(f"softcap {cap} < 0")
    if seq_index < 0:
        raise ValueError(f"seq_index {seq_index} < 0")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: torch.Tensor,
                     cache_positions: torch.Tensor, scale: float, cap: float,
                     window: int = 0, seq_index: int = 0,
                     partial: bool = False) -> torch.Tensor:
    """Launch the kernel on the current stream. Returns (B, 1, Hq, D) in the
    caches' dtype, or with ``partial`` the f32 (B, Hkv, G, D + 2) partial
    (m, l, o) of rank ``seq_index`` of a cache whose slots are split over a
    sequence group (``ref.decode_partial``). Row b reads only slots [0,
    ``ref.slot_bound``). Does not synchronise; raises if the launch is
    refused. Counts each call in ``LAUNCHES``. On meta tensors (the dry
    run) returns the output's shape and counts the cost, launching
    nothing."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"the CUDA kernel needs CUDA tensors; got {q.device}")
    check_inputs(q, k_cache, v_cache, pos, cache_positions, cap=cap,
                 window=window, seq_index=seq_index)
    B, _, Hq, D = q.shape
    _, T, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    out = (torch.empty((B, Hkv, G, D + 2), dtype=torch.float32, device=q.device)
           if partial else
           torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device))
    cost = (decode_cost, B, T, Hq, Hkv, D, q.element_size())
    if q.device.type == "meta":
        note_cost("decode_attention", *cost)
        return out
    splits, chunk = _card_plan(q.device, B, T, Hkv, G, D, q.dtype)
    _launch(q, k_cache, v_cache, pos, cache_positions, out, scale=scale,
            cap=cap, window=window, seq_index=seq_index, partial=partial,
            splits=splits, chunk=chunk)
    LAUNCHES["decode_attention"] += 1
    note_cost("decode_attention", *cost)
    return out


def _launch(q, k_cache, v_cache, pos, cache_positions, out, *, scale, cap,
            window, seq_index, partial, splits, chunk) -> None:
    """One launch at a given split of the slot axis (``plan``'s, or another
    for a measurement of the choice)."""
    B, _, Hq, D = q.shape
    _, T, Hkv, _ = k_cache.shape
    if splits * chunk < T or splits > _MAX_GRID_YZ:
        raise ValueError(f"{splits} splits of {chunk} slots for {T} slots")
    pos = pos.to(torch.int32).contiguous()
    ws = (torch.empty((B, Hkv, splits, Hq // Hkv, D + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    strides = (ctypes.c_int64 * 9)(
        q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
        cache_positions.stride(0))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), cache_positions.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), strides, B, T, Hkv,
            Hq // Hkv, D, _DTYPES[q.dtype], float(scale), float(cap),
            int(window), int(seq_index), int(splits), int(chunk),
            int(bool(partial)), stream)
    build.check(lib, err, "decode_attention launch")
