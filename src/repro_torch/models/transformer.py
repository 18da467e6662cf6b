"""Decoder-stack assembly for every layer kind (dense, local, global, moe,
mamba, rglru), the port of ``repro/models/transformer.py``.

The parameter tree keeps the reference's layout: ``embed``, ``final_ln``,
``scan/{i:kind}`` for the periods of the layer pattern and ``rem/{j:kind}``
for the remainder. The reference stacks each ``scan`` entry on a leading
periods axis for ``lax.scan``; here a Python loop replaces the scan, so each
``scan`` entry is a list with one block per period.

Under autograd each block is rematerialized when ``cfg.remat`` is not
"none": ``torch.utils.checkpoint`` keeps the block's input and recomputes
the block in the backward pass, as the reference's ``jax.checkpoint`` does.
What the recompute may take from the forward follows the reference's
policies:
  * "full" saves nothing but the block's input;
  * "dots" also saves every product without batch dims (``aten.mm`` and
    ``aten.addmm``: the 2-D weight products, not attention's or the
    experts' batched ones), the twin of
    ``checkpoint_dots_with_no_batch_dims``, through a selective
    checkpoint policy;
  * "comm" also saves the post-all-reduce sublayer outputs (attention,
    MLP or MoE, mixer), the twin of ``save_only_these_names("attn_out",
    "ffn_out", "mixer_out")``: the collectives are ``autograd.Function``s
    over gloo, which no aten-level policy sees, so the block runs under
    ``TPContext.keeping`` and its recompute takes each such sum from the
    forward instead of all-reducing again (the partial's product is
    recomputed, as eager code cannot drop it). Off a ``model`` > 1 mesh it
    is "full".
All three give the same gradients, bit for bit.

On a mesh one ``tp`` context (``train.sharding.TPContext``: the mesh, the
rules, the head plan) goes through every block and the unembed; without
it every path is the one-device one, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import kvcache, moe as moe_lib
from repro_torch.models import rglru as rglru_lib, ssm as ssm_lib
from repro_torch.models.layers import (
    embed, embed_specs, mlp, mlp_specs, rms_norm, rms_norm_spec, softcap,
    stack_specs, to_dtype, tree_map, unembed, unstack,
)


# the MoE aux losses, summed over the moe layers (0 without any)
AUX0 = {"moe_lb": 0.0, "moe_z": 0.0}


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
    s: dict[str, Any] = {"ln1": rms_norm_spec(cfg.d_model, plus)}
    if kind == "mamba":
        s["mamba"] = ssm_lib.mamba_specs(cfg)
        return s
    mlp_spec = mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_glu, cfg.param_dtype)
    if kind == "rglru":
        s["rglru"] = rglru_lib.rglru_specs(cfg)
        s["ln2"] = rms_norm_spec(cfg.d_model, plus)
        s["mlp"] = mlp_spec
        return s
    s["attn"] = attn_lib.attn_specs(cfg)
    s["ln2"] = rms_norm_spec(cfg.d_model, plus)
    if kind == "moe":
        s["moe"] = moe_lib.moe_specs(cfg)
    else:
        s["mlp"] = mlp_spec
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
    return _layout(cfg, lambda kind: kvcache.layer_cache_specs(cfg, kind, B, T))


def unstack_scan(tree: dict, cfg) -> dict:
    """Split each stacked ``scan`` entry into a list of per-period trees."""
    n_scan, _ = _plan(cfg)
    return {**tree, "scan": {k: unstack(t, n_scan)
                             for k, t in tree["scan"].items()}}


def unstack_scan_specs(spec_tree: dict, cfg) -> dict:
    """``unstack_scan`` for a spec tree: each stacked ``scan`` spec becomes a
    list of per-period specs without the periods axis."""
    n_scan, _ = _plan(cfg)
    return {**spec_tree, "scan": {
        k: [tree_map(lambda s: dataclasses.replace(s, shape=s.shape[1:],
                                                   axes=s.axes[1:]), t)
            for _ in range(n_scan)]
        for k, t in spec_tree["scan"].items()}}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def apply_block(kind: str, p: dict, x: torch.Tensor, *, cfg,
                positions: torch.Tensor, cache: Optional[dict],
                return_cache: bool, cache_len: int = 0, tp=None):
    """One layer. Returns (x, aux, new_cache), aux the layer's MoE losses
    ({} for every kind but moe)."""
    eps, plus = cfg.norm_eps, cfg.scale_embeddings
    h = rms_norm(x, p["ln1"], eps, plus)
    if kind == "mamba":
        out, new_cache = ssm_lib.mamba_block(
            p["mamba"], h, cfg=cfg, cache=cache, return_cache=return_cache,
            tp=tp)
        return x + out, {}, new_cache
    if kind == "rglru":
        out, new_cache = rglru_lib.rglru_block(
            p["rglru"], h, cfg=cfg, cache=cache, return_cache=return_cache,
            tp=tp)
        x = x + out
        x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], eps, plus), cfg.mlp_act,
                    tp)
        return x, {}, new_cache
    a_out, new_cache = attn_lib.attention(
        p["attn"], h, cfg=cfg, kind="global" if kind == "moe" else kind,
        positions=positions, cache=cache, return_cache=return_cache,
        cache_len=cache_len, tp=tp)
    if cfg.post_norms:
        a_out = rms_norm(a_out, p["ln1_post"], eps, plus)
    x = x + a_out
    h2 = rms_norm(x, p["ln2"], eps, plus)
    aux = {}
    if kind == "moe":
        f_out, aux = moe_lib.moe_block(p["moe"], h2, cfg=cfg, tp=tp)
    else:
        f_out = mlp(p["mlp"], h2, cfg.mlp_act, tp)
    if cfg.post_norms:
        f_out = rms_norm(f_out, p["ln2_post"], eps, plus)
    return x + f_out, aux, new_cache


REMAT = ("none", "full", "dots", "comm")
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(block, policy: str, tp, *args):
    """``block(*args)`` under ``torch.utils.checkpoint`` with the remat
    ``policy`` (module docstring)."""
    if policy not in REMAT:
        raise ValueError(f"remat {policy!r} not in {REMAT}")
    if policy == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        return torch.utils.checkpoint.checkpoint(
            block, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(_dots_policy))
    if policy == "comm" and tp is not None and tp.m > 1:
        from repro_torch.train.sharding import KeptSums
        store = KeptSums()

        def keeping(*a):
            with tp.keeping(store):
                return block(*a)
        return torch.utils.checkpoint.checkpoint(keeping, *args,
                                                 use_reentrant=False)
    return torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)


def apply_stack(params: dict, x: torch.Tensor, *, cfg,
                positions: torch.Tensor, cache: Optional[dict] = None,
                return_cache: bool = False, cache_len: int = 0, tp=None):
    """Runs all layers in order. Returns (x, aux, new_cache or None), aux
    the MoE losses summed over the layers."""
    pat = cfg.layer_pattern
    n_scan, n_rem = _plan(cfg)
    use_cache = cache is not None
    aux = dict(AUX0)
    new_cache: dict[str, Any] = {
        "scan": {_key(i, k): [] for i, k in enumerate(pat)} if n_scan else {},
        "rem": {}}

    def block(kind, p, x, c_in):
        return apply_block(kind, p, x, cfg=cfg, positions=positions,
                           cache=c_in, return_cache=return_cache,
                           cache_len=cache_len, tp=tp)

    remat = (cfg.remat != "none" and torch.is_grad_enabled()
             and not use_cache and not return_cache)

    def run(kind, p, x, c_in):
        if remat:
            out = _checkpointed(block, cfg.remat, tp, kind, p, x, c_in)
        else:
            out = block(kind, p, x, c_in)
        x, block_aux, nc = out
        for name, val in block_aux.items():
            aux[name] = aux[name] + val
        return x, nc

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
    return x, aux, (new_cache if (use_cache or return_cache) else None)


def apply_transformer(params: dict, tokens: torch.Tensor, *, cfg,
                      positions: Optional[torch.Tensor] = None,
                      prefix_embed: Optional[torch.Tensor] = None,
                      cache: Optional[dict] = None,
                      return_cache: bool = False, cache_len: int = 0,
                      tp=None):
    """Returns (hidden (B,S_total,M), aux, new_cache), aux the MoE losses
    summed over the layers. ``prefix_embed`` (B,P,M), precomputed frontend
    embeddings (paligemma's patches), goes before the embedded tokens, so
    S_total = P + S. Logits are the caller's."""
    cdt = to_dtype(cfg.compute_dtype)
    x = embed(params["embed"], tokens, cfg.scale_embeddings, cdt, tp)
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(cdt), x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    x, aux, new_cache = apply_stack(params, x, cfg=cfg, positions=positions,
                                    cache=cache, return_cache=return_cache,
                                    cache_len=cache_len, tp=tp)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps, cfg.scale_embeddings)
    return x, aux, new_cache


def logits_from_hidden(params: dict, hidden: torch.Tensor, cfg,
                       tp=None) -> torch.Tensor:
    """The logits, gathered over ``model`` under ``tp`` before the softcap."""
    lg = unembed(params["embed"], hidden, cfg.tie_embeddings, tp)
    return softcap(lg, cfg.logit_softcap)
