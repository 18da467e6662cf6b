"""Attention block, the port of ``repro/models/attention.py`` (the dense,
local and global kinds, and a moe layer's attention, which is global): GQA
projections with optional biases, optional q/k RMS norms, RoPE, prefill
through the flash-attention wrapper (with the prefix-LM prefix on every
layer but the local ones, as the reference passes it), one-token decode
against a KV cache.

Under tensor parallelism (``tp``) a rank holds the columns of ``wq`` for
its query heads (``train.sharding.head_plan``), an even share of the
columns of ``wk``/``wv`` (the reference's shard), and the rows of ``wo``
for its heads, which is row-parallel. Where its heads read KV columns that
other ranks hold (a KV head shared across ranks: MQA, or fewer KV heads
than ranks), it gathers them (``TPContext.attn_weights``). Where ``model``
divides neither the heads nor ``pad_heads_to``, ``wq`` is cut mid-head too:
every rank gathers q, k and v whole, computes every head and keeps its own
columns of the output for ``wo``. Prefill runs the flash kernel on the
rank's projections. Where the rank's heads do not group G' to a KV head (a
KV head shared across a rank boundary), each head gets its KV head's copy.
With ``pad_heads_to`` a rank's share of the padded heads may hold fewer
real heads than another's; the pad heads are skipped, which changes no
logit (the reference slices them off before ``wo``). In training the
gradient of the q/k norm scales is on each rank the part its own heads
give: the train step sums it over the ranks (``train_step.TrainSetup``,
``sharding.shared_over_model``); a gathered projection's gradient is summed
by its gather's backward. Decode with a
sequence-sharded cache (``tp.seq``): each ``data`` rank scores its slots
and keeps an f32 partial (max, sum, unnormalised output); the partials are
combined over ``data``, as GSPMD's SP all-reduces combine them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.flash_attention.ops import gqa_attention
from repro_torch.models import kvcache
from repro_torch.models.layers import (
    ParamSpec, dense, rms_norm, rope, row_dense,
)
from repro_torch.spans import span


def attn_specs(cfg) -> dict[str, ParamSpec]:
    """Projections stored flattened (M, H*D), as the reference stores them."""
    M, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pdt = cfg.param_dtype
    specs = {
        "wq": ParamSpec((M, Hq * D), pdt, axes=("embed", "qkv")),
        "wk": ParamSpec((M, Hkv * D), pdt, axes=("embed", "kv_flat")),
        "wv": ParamSpec((M, Hkv * D), pdt, axes=("embed", "kv_flat")),
        "wo": ParamSpec((Hq * D, M), pdt, axes=("qkv", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((Hq * D,), pdt, init="zeros", axes=("qkv",))
        specs["bk"] = ParamSpec((Hkv * D,), pdt, init="zeros",
                                axes=("kv_flat",))
        specs["bv"] = ParamSpec((Hkv * D,), pdt, init="zeros",
                                axes=("kv_flat",))
    if cfg.qk_norm:   # f32 whatever the param dtype, as the reference declares
        specs["q_norm"] = ParamSpec((D,), init="ones", axes=("head_dim",))
        specs["k_norm"] = ParamSpec((D,), init="ones", axes=("head_dim",))
    return specs


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: torch.Tensor,
                     cache_positions: torch.Tensor, scale: float, cap: float,
                     window: int = 0, group=None) -> torch.Tensor:
    """One-token decode. q: (B,1,Hq,D); caches: (B,T,Hkv,D); pos: (B,)
    position of the new token; cache_positions: (B,T) position held by each
    slot, < 0 when empty. Returns (B,1,Hq,D).

    A CPU tensor runs the plain version (``kernels/decode_attention/ref.py``);
    a CUDA or meta tensor goes to the hand-written kernel, which launches or
    raises. With ``group`` (an ``AxisGroup``) the cache's slots are split
    across its ranks and this rank holds ``k_cache``'s share: each rank's
    f32 partial (max m, sum l, unnormalised output o) is gathered, and every
    rank combines them alike, out = sum_i e^(m_i - M) o_i / sum_i e^(m_i -
    M) l_i, M the largest m_i (a rank none of whose slots is valid
    contributes e^(-2e38 - M) = 0)."""
    kw = dict(pos=pos, cache_positions=cache_positions, scale=scale, cap=cap,
              window=window)
    if q.device.type == "cpu":
        return decode_ref.decode_attention(q, k_cache, v_cache, group=group, **kw)
    if group is None:
        return decode_kernel.decode_attention(q, k_cache, v_cache, **kw)
    part = decode_kernel.decode_attention(q, k_cache, v_cache, **kw,
                                          seq_index=group.index, partial=True)
    return decode_ref.combine(group.all_gather(part), v_cache.dtype)


def attention(params: dict, x: torch.Tensor, *, cfg, kind: str,
              positions: torch.Tensor, cache: Optional[dict] = None,
              return_cache: bool = False, cache_len: int = 0, tp=None):
    """kind: dense|global|local (a moe layer's attention is global). x:
    (B,S,M). positions: (B,S) absolute.

    Prefill (cache None): returns (y, new_cache or None).
    Decode (cache given, S == 1): returns (y, cache updated in place).
    """
    B, S, _ = x.shape
    D = cfg.head_dim
    Hq, Hkv = params["wq"].shape[1] // D, params["wk"].shape[1] // D
    kv_index = tp.kv_index if tp is not None else None
    scale = cfg.query_scale or D ** -0.5
    window = cfg.attn_window if kind == "local" else 0
    theta = cfg.rope_theta if kind != "local" else min(cfg.rope_theta, 10_000.0)

    if tp is not None:
        x = tp.to_model(x)
        params = tp.attn_weights(params)
        Hq, Hkv = params["wq"].shape[1] // D, params["wk"].shape[1] // D
    q, k, v = (dense(x, params[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(B, S, Hq, D)
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    # the global caches' slots split over `data` (SP decode); rings whole
    seq_group = tp.seq if tp is not None and not window else None
    seq = None if seq_group is None else (seq_group.index, seq_group.size)

    if cache is not None:
        if S != 1:
            raise ValueError(f"decode takes one token per sequence, got {S}")
        with span("kv"):
            new_cache = kvcache.cache_insert(cache, k, v, positions[:, 0], seq)
    elif return_cache:
        with span("kv"):
            new_cache = kvcache.cache_from_prefill(
                k, v, positions, window=window, max_len=cache_len, seq=seq)
    else:
        new_cache = None

    if Hq == 0:          # a rank whose share of the padded heads is all pad
        o = q
    elif cache is not None:
        T = new_cache["k"].shape[1]
        kc = new_cache["k"].reshape(B, T, Hkv, D)
        vc = new_cache["v"].reshape(B, T, Hkv, D)
        if kv_index is not None:
            kc, vc = kc[:, :, kv_index], vc[:, :, kv_index]
        with span("attn.decode"):
            o = decode_attention(
                q, kc, vc, pos=positions[:, 0], cache_positions=new_cache["pos"],
                scale=scale, cap=cfg.attn_softcap, window=window, group=seq_group)
    else:
        # the prefix-LM prefix binds on every prefill but a local layer's,
        # with or without prefix embeddings (the reference's rule); decode
        # sees every cached key up to its own position anyway
        prefix = (cfg.n_prefix if cfg.prefix_bidirectional and not window
                  else 0)
        k_att, v_att = ((k, v) if kv_index is None else
                        (k[:, :, kv_index], v[:, :, kv_index]))
        with span("attn.flash"):
            o = gqa_attention(q, k_att, v_att, scale=scale,
                              softcap=cfg.attn_softcap, causal=True,
                              window=window, prefix=prefix)
    o = o.reshape(B, S, Hq * D)
    if tp is not None:
        o = tp.own_columns(o)
    return row_dense(o, params["wo"], tp), new_cache
