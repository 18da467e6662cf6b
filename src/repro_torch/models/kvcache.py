"""KV caches for decode, the attention part of ``repro/models/kvcache.py``.

Caches hold the absolute position of each slot, so local layers use a ring
(slot = pos % window) with the same insert path as global layers; an empty
slot holds pos = -1. k/v are stored flat as (B, T, Hkv*D).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import ParamSpec


def attn_cache_specs(cfg, B: int, T: int, kind: str) -> dict[str, ParamSpec]:
    """kind local -> ring of size min(window, T); else T slots."""
    size = min(cfg.attn_window, T) if kind == "local" else T
    F = cfg.n_kv_heads * cfg.head_dim
    return {
        "k": ParamSpec((B, size, F), cfg.compute_dtype, init="zeros"),
        "v": ParamSpec((B, size, F), cfg.compute_dtype, init="zeros"),
        "pos": ParamSpec((B, size), torch.int32, init="neg_ones"),
    }


def cache_insert(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> dict:
    """Insert one token per sequence, in place (the reference donates the
    cache to its decode step). k_new/v_new: (B,1,Hkv,D); pos: (B,)."""
    B = k_new.shape[0]
    T = cache["k"].shape[1]
    b = torch.arange(B, device=pos.device)
    slot = (pos % T).long()
    cache["k"][b, slot] = k_new.reshape(B, -1).to(cache["k"].dtype)
    cache["v"][b, slot] = v_new.reshape(B, -1).to(cache["v"].dtype)
    cache["pos"][b, slot] = pos.to(cache["pos"].dtype)
    return cache


def cache_from_prefill(k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, window: int = 0,
                       max_len: int = 0) -> dict:
    """Build a cache from prefill k/v (B,S,Hkv,D), rope applied.

    Global: the cache is the kv sequence, padded with empty slots to
    `max_len` so decode inserts do not evict. Local: a ring of `window`
    slots holding the last min(S, window) entries at slot = pos % window.
    Unlike the reference, a prompt shorter than the window keeps position 0:
    the reference's padding entries (pos -1) all scatter to slot 0 and
    overwrite it.
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
