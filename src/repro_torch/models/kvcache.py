"""KV and state caches for decode, the port of ``repro/models/kvcache.py``:
attention caches (a moe layer's attention too), and the mamba and RG-LRU
state caches.

Caches hold the absolute position of each slot, so local layers use a ring
(slot = pos % window) with the same insert path as global layers; an empty
slot holds pos = -1. k/v are stored flat as (B, T, Hkv*D).

The specs carry the reference's logical axes, so on a mesh each rank holds
its share (``train.sharding.local_specs``): its batch rows, its KV heads
(``kv_cache``, the reference's ``kv_flat``: the heads its query heads
read), its mamba or RG-LRU channels, and under ``seq_shard_kv`` its slot range of each global cache
(``kv_seq`` over ``data``: ``seq`` below is this rank's (index, count)
there); local rings stay whole on every ``data`` rank, as the reference's
rule has it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import ParamSpec


def attn_cache_specs(cfg, B: int, T: int, kind: str) -> dict[str, ParamSpec]:
    """kind local -> ring of size min(window, T); else T slots."""
    size = min(cfg.attn_window, T) if kind == "local" else T
    seq_ax = "kv_seq" if kind != "local" else None   # rings are small
    F = cfg.n_kv_heads * cfg.head_dim
    kv = ("batch", seq_ax, "kv_cache")     # the reference's kv_flat
    return {
        "k": ParamSpec((B, size, F), cfg.compute_dtype, init="zeros", axes=kv),
        "v": ParamSpec((B, size, F), cfg.compute_dtype, init="zeros", axes=kv),
        "pos": ParamSpec((B, size), torch.int32, init="neg_ones",
                         axes=("batch", seq_ax)),
    }


def mamba_cache_specs(cfg, B: int) -> dict[str, ParamSpec]:
    """conv: the last K-1 conv inputs in the compute dtype; h: the f32 state."""
    s, di = cfg.ssm, cfg.d_inner
    return {
        "conv": ParamSpec((B, s.d_conv - 1, di), cfg.compute_dtype,
                          init="zeros", axes=("batch", None, "inner")),
        "h": ParamSpec((B, di, s.d_state), torch.float32, init="zeros",
                       axes=("batch", "inner", "state")),
    }


def rglru_cache_specs(cfg, B: int) -> dict[str, ParamSpec]:
    """conv: the last K-1 conv inputs in the compute dtype; h: the f32 state."""
    dr = cfg.d_rnn
    return {
        "conv": ParamSpec((B, cfg.rglru.d_conv - 1, dr), cfg.compute_dtype,
                          init="zeros", axes=("batch", None, "rnn")),
        "h": ParamSpec((B, dr), torch.float32, init="zeros",
                       axes=("batch", "rnn")),
    }


def layer_cache_specs(cfg, kind: str, B: int, T: int) -> dict[str, ParamSpec]:
    if kind == "mamba":
        return mamba_cache_specs(cfg, B)
    if kind == "rglru":
        return rglru_cache_specs(cfg, B)
    return attn_cache_specs(cfg, B, T, kind)


def cache_insert(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor, seq: Optional[tuple[int, int]] = None) -> dict:
    """Insert one token per sequence, in place (the reference donates the
    cache to its decode step). k_new/v_new: (B,1,Hkv,D); pos: (B,). With
    ``seq`` = (index, n) the cache is this rank's slot range of a global
    one n times as long: a row's token lands only on the rank that owns
    slot pos % T (the others write back what the slot held)."""
    B = k_new.shape[0]
    T = cache["k"].shape[1]
    b = torch.arange(B, device=pos.device)
    k_new = k_new.reshape(B, -1).to(cache["k"].dtype)
    v_new = v_new.reshape(B, -1).to(cache["v"].dtype)
    pos = pos.to(cache["pos"].dtype)
    if seq is None:
        slot = (pos % T).long()
    else:
        index, n = seq
        slot = (pos % (T * n)).long() - index * T
        mine = (slot >= 0) & (slot < T)
        slot = slot.clamp(0, T - 1)
        k_new = torch.where(mine[:, None], k_new, cache["k"][b, slot])
        v_new = torch.where(mine[:, None], v_new, cache["v"][b, slot])
        pos = torch.where(mine, pos, cache["pos"][b, slot])
    cache["k"][b, slot] = k_new
    cache["v"][b, slot] = v_new
    cache["pos"][b, slot] = pos
    return cache


def cache_from_prefill(k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, window: int = 0,
                       max_len: int = 0,
                       seq: Optional[tuple[int, int]] = None) -> dict:
    """Build a cache from prefill k/v (B,S,Hkv,D), rope applied.

    Global: the cache is the kv sequence, padded with empty slots to
    `max_len` so decode inserts do not evict. Local: a ring of `window`
    slots holding the last min(S, window) entries at slot = pos % window.
    Unlike the reference, a prompt shorter than the window keeps position 0:
    the reference's padding entries (pos -1) all scatter to slot 0 and
    overwrite it. With ``seq`` = (index, n) a global cache keeps this
    rank's n-th share of its slots (n must divide them).
    """
    B, S = k.shape[:2]
    k = k.reshape(B, S, -1)
    v = v.reshape(B, S, -1)
    positions = positions.to(torch.int32).contiguous()  # may be a broadcast view
    if not window:
        pad = max(max_len - S, 0)
        if pad:
            k = torch.cat([k, k.new_zeros(B, pad, k.shape[2])], dim=1)
            v = torch.cat([v, v.new_zeros(B, pad, v.shape[2])], dim=1)
            positions = torch.cat(
                [positions, positions.new_full((B, pad), -1)], dim=1)
        if seq is not None:
            index, n = seq
            T = k.shape[1]
            if T % n:
                raise ValueError(f"a cache of {T} slots does not split over "
                                 f"{n} ranks of the sequence axis")
            mine = slice(index * (T // n), (index + 1) * (T // n))
            k, v, positions = (t[:, mine].clone() for t in (k, v, positions))
        return {"k": k, "v": v, "pos": positions}
    keep = min(S, window)
    k, v, positions = k[:, -keep:], v[:, -keep:], positions[:, -keep:]
    b = torch.arange(B, device=k.device)[:, None]
    slots = (positions % window).long()
    ring_k = k.new_zeros(B, window, k.shape[2])
    ring_v = v.new_zeros(B, window, v.shape[2])
    ring_pos = positions.new_full((B, window), -1)
    ring_k[b, slots] = k
    ring_v[b, slots] = v
    ring_pos[b, slots] = positions
    return {"k": ring_k, "v": ring_v, "pos": ring_pos}
