"""Decoder-stack assembly for the dense/local/global kinds, the port of
``repro/models/transformer.py``.

The parameter tree keeps the reference's layout: ``embed``, ``final_ln``,
``scan/{i:kind}`` for the periods of the layer pattern and ``rem/{j:kind}``
for the remainder. The reference stacks each ``scan`` entry on a leading
periods axis for ``lax.scan``; here a Python loop replaces the scan, so each
``scan`` entry is a list with one block per period.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import kvcache
from repro_torch.models.layers import (
    embed, embed_specs, mlp, mlp_specs, rms_norm, rms_norm_spec, softcap,
    stack_specs, to_dtype, unembed, unstack,
)


def _key(i: int, kind: str) -> str:
    return f"{i}:{kind}"


def _plan(cfg) -> tuple[int, int]:
    """(n_scan_periods, n_remainder_layers)."""
    p = len(cfg.layer_pattern)
    n_scan = cfg.n_layers // p if cfg.scan_layers else 0
    if n_scan < 2:
        n_scan = 0
    return n_scan, cfg.n_layers - n_scan * p


# ---------------------------------------------------------------------------
# Specs: the reference's tree, stacked scan entries included
# ---------------------------------------------------------------------------


def block_specs(cfg, kind: str) -> dict:
    plus = cfg.scale_embeddings  # gemma-family (1+w) norm convention
    s: dict[str, Any] = {
        "ln1": rms_norm_spec(cfg.d_model, plus),
        "attn": attn_lib.attn_specs(cfg),
        "ln2": rms_norm_spec(cfg.d_model, plus),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_glu, cfg.param_dtype),
    }
    if cfg.post_norms:
        s["ln1_post"] = rms_norm_spec(cfg.d_model, plus)
        s["ln2_post"] = rms_norm_spec(cfg.d_model, plus)
    return s


def _layout(cfg, layer) -> dict:
    n_scan, n_rem = _plan(cfg)
    pat = cfg.layer_pattern
    return {
        "scan": {_key(i, k): stack_specs(layer(k), n_scan)
                 for i, k in enumerate(pat)} if n_scan else {},
        "rem": {_key(j, pat[j % len(pat)]): layer(pat[j % len(pat)])
                for j in range(n_rem)},
    }


def transformer_specs(cfg) -> dict:
    return {
        "embed": embed_specs(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                             cfg.param_dtype),
        "final_ln": rms_norm_spec(cfg.d_model, cfg.scale_embeddings),
        **_layout(cfg, lambda kind: block_specs(cfg, kind)),
    }


def cache_specs(cfg, B: int, T: int) -> dict:
    return _layout(cfg, lambda kind: kvcache.attn_cache_specs(cfg, B, T, kind))


def unstack_scan(tree: dict, cfg) -> dict:
    """Split each stacked ``scan`` entry into a list of per-period trees."""
    n_scan, _ = _plan(cfg)
    return {**tree, "scan": {k: unstack(t, n_scan)
                             for k, t in tree["scan"].items()}}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def apply_block(kind: str, p: dict, x: torch.Tensor, *, cfg,
                positions: torch.Tensor, cache: Optional[dict],
                return_cache: bool, cache_len: int = 0):
    eps, plus = cfg.norm_eps, cfg.scale_embeddings
    h = rms_norm(x, p["ln1"], eps, plus)
    a_out, new_cache = attn_lib.attention(
        p["attn"], h, cfg=cfg, kind=kind, positions=positions, cache=cache,
        return_cache=return_cache, cache_len=cache_len)
    if cfg.post_norms:
        a_out = rms_norm(a_out, p["ln1_post"], eps, plus)
    x = x + a_out
    f_out = mlp(p["mlp"], rms_norm(x, p["ln2"], eps, plus), cfg.mlp_act)
    if cfg.post_norms:
        f_out = rms_norm(f_out, p["ln2_post"], eps, plus)
    return x + f_out, new_cache


def apply_stack(params: dict, x: torch.Tensor, *, cfg,
                positions: torch.Tensor, cache: Optional[dict] = None,
                return_cache: bool = False, cache_len: int = 0):
    """Runs all layers in order. Returns (x, new_cache or None)."""
    pat = cfg.layer_pattern
    n_scan, n_rem = _plan(cfg)
    use_cache = cache is not None
    new_cache: dict[str, Any] = {
        "scan": {_key(i, k): [] for i, k in enumerate(pat)} if n_scan else {},
        "rem": {}}

    def run(kind, p, x, c_in):
        return apply_block(kind, p, x, cfg=cfg, positions=positions,
                           cache=c_in, return_cache=return_cache,
                           cache_len=cache_len)

    for period in range(n_scan):
        for i, kind in enumerate(pat):
            key = _key(i, kind)
            c_in = cache["scan"][key][period] if use_cache else None
            x, nc = run(kind, params["scan"][key][period], x, c_in)
            if nc is not None:
                new_cache["scan"][key].append(nc)
    for j in range(n_rem):
        kind = pat[j % len(pat)]
        key = _key(j, kind)
        x, nc = run(kind, params["rem"][key], x,
                    cache["rem"][key] if use_cache else None)
        if nc is not None:
            new_cache["rem"][key] = nc
    return x, (new_cache if (use_cache or return_cache) else None)


def apply_transformer(params: dict, tokens: torch.Tensor, *, cfg,
                      positions: Optional[torch.Tensor] = None,
                      cache: Optional[dict] = None,
                      return_cache: bool = False, cache_len: int = 0):
    """Returns (hidden (B,S,M), new_cache). Logits are the caller's."""
    x = embed(params["embed"], tokens, cfg.scale_embeddings,
              to_dtype(cfg.compute_dtype))
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    x, new_cache = apply_stack(params, x, cfg=cfg, positions=positions,
                               cache=cache, return_cache=return_cache,
                               cache_len=cache_len)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps, cfg.scale_embeddings)
    return x, new_cache


def logits_from_hidden(params: dict, hidden: torch.Tensor, cfg) -> torch.Tensor:
    lg = unembed(params["embed"], hidden, cfg.tie_embeddings)
    return softcap(lg, cfg.logit_softcap)
