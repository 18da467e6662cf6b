"""Attention block, the port of ``repro/models/attention.py`` for the
dense/local/global kinds: GQA projections, RoPE, prefill through the
flash-attention wrapper, one-token decode against a KV cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import gqa_attention
from repro_torch.models import kvcache
from repro_torch.models.layers import ParamSpec, dense, rope, softcap

NEG_INF = -2.0e38


def attn_specs(cfg) -> dict[str, ParamSpec]:
    """Projections stored flattened (M, H*D), as the reference stores them."""
    M, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pdt = cfg.param_dtype
    return {
        "wq": ParamSpec((M, Hq * D), pdt),
        "wk": ParamSpec((M, Hkv * D), pdt),
        "wv": ParamSpec((M, Hkv * D), pdt),
        "wo": ParamSpec((Hq * D, M), pdt),
    }


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: torch.Tensor,
                     cache_positions: torch.Tensor, scale: float, cap: float,
                     window: int = 0) -> torch.Tensor:
    """One-token decode, plain torch (the reference has no kernel for it).
    q: (B,1,Hq,D); caches: (B,T,Hkv,D); pos: (B,) position of the new token;
    cache_positions: (B,T) position held by each slot, < 0 when empty.
    Returns (B,1,Hq,D)."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bthd->bhgt", qg.float(), k_cache.float())
    s = softcap(s * scale, cap)
    valid = (cache_positions >= 0) & (cache_positions <= pos[:, None])
    if window:
        valid &= (pos[:, None] - cache_positions) < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, Hq, D)


def attention(params: dict, x: torch.Tensor, *, cfg, kind: str,
              positions: torch.Tensor, cache: Optional[dict] = None,
              return_cache: bool = False, cache_len: int = 0):
    """kind: dense|global|local. x: (B,S,M). positions: (B,S) absolute.

    Prefill (cache None): returns (y, new_cache or None).
    Decode (cache given, S == 1): returns (y, cache updated in place).
    """
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = cfg.query_scale or D ** -0.5
    window = cfg.attn_window if kind == "local" else 0
    theta = cfg.rope_theta if kind != "local" else min(cfg.rope_theta, 10_000.0)

    q = dense(x, params["wq"]).reshape(B, S, Hq, D)
    k = dense(x, params["wk"]).reshape(B, S, Hkv, D)
    v = dense(x, params["wv"]).reshape(B, S, Hkv, D)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)

    if cache is not None:
        if S != 1:
            raise ValueError(f"decode takes one token per sequence, got {S}")
        new_cache = kvcache.cache_insert(cache, k, v, positions[:, 0])
        T = new_cache["k"].shape[1]
        o = decode_attention(
            q, new_cache["k"].reshape(B, T, Hkv, D),
            new_cache["v"].reshape(B, T, Hkv, D), pos=positions[:, 0],
            cache_positions=new_cache["pos"], scale=scale,
            cap=cfg.attn_softcap, window=window)
    else:
        o = gqa_attention(q, k, v, scale=scale, softcap=cfg.attn_softcap,
                          causal=True, window=window)
        new_cache = None
        if return_cache:
            new_cache = kvcache.cache_from_prefill(k, v, positions,
                                                   window=window,
                                                   max_len=cache_len)
    return dense(o.reshape(B, S, Hq * D), params["wo"]), new_cache
