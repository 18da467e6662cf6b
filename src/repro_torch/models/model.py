"""Public model API: init / loss / prefill / decode, the port of
``repro/models/model.py`` for every architecture of the registry.

The loss is a sequence-chunked cross-entropy: the full (B, S, V) logits are
never made (V is 256000 for gemma2), and each chunk's unembed is recomputed
in the backward pass (``torch.utils.checkpoint`` around the chunk, where the
reference puts ``jax.checkpoint``).

On a mesh (``tp``) the cross-entropy is vocab-parallel: each rank's logits
are its vocab columns, never gathered; the log-partition comes from the max
and the sum of exponentials over ``model`` (``TPContext.logsumexp``), and
the target's logit from the rank that holds it, summed over ``model``
(``TPContext.reduce``). A chunk's recompute replays its collectives, on
every rank alike."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (abstract_params, init_params, softcap,
                                      to_dtype, unembed)

Tree = Any


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # -- params -----------------------------------------------------------
    def param_specs(self) -> Tree:
        """The reference's spec tree (stacked ``scan`` entries)."""
        return tfm.transformer_specs(self.cfg)

    def init(self, seed: int = 0, device: str | torch.device = "cuda",
             mesh=None, rules: Optional[dict] = None) -> Tree:
        """Seeded init; ``scan`` entries come out per period. With a
        ``mesh`` and its ``rules`` (``train.sharding.make_rules``) this
        rank's shard: every leaf drawn whole in the one-device order and cut
        to its share, so its bits are the one-device init's."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        cut = None
        if mesh is not None:
            from repro_torch.train.sharding import local_slice

            def cut(spec):
                return local_slice(spec, mesh, rules, self.cfg)
        return tfm.unstack_scan(init_params(self.param_specs(), gen, dev, cut),
                                self.cfg)

    def abstract_params(self, mesh=None, rules: Optional[dict] = None) -> Tree:
        """``init``'s tree as meta tensors (shapes and dtypes, no storage),
        ``scan`` entries per period as views of one stacked tensor, as
        ``init`` gives them; with a ``mesh`` and its ``rules`` this rank's
        shares (``train.sharding.local_specs``)."""
        specs = self.param_specs()
        if mesh is not None:
            from repro_torch.train.sharding import local_specs
            specs = local_specs(specs, mesh, rules, self.cfg)
        return tfm.unstack_scan(abstract_params(specs), self.cfg)

    def compute_params(self, params: Tree) -> Tree:
        """Cast every weight matrix to the compute dtype once. The layers
        cast each weight to the compute dtype where they use it (as the
        reference does), so this changes no result; it saves that cast on
        every step. Norm scales and biases (1-D) stay in the param dtype,
        and so does every parameter whose spec says ``keep_dtype`` (mamba's
        ``A_log`` and ``D``, the MoE router and RG-LRU's ``lam``, declared
        and used in f32)."""
        cdt = to_dtype(self.cfg.compute_dtype)

        def cast(spec, t):
            if isinstance(t, list):   # a stacked spec's per-period trees
                return [cast(spec, p) for p in t]
            if isinstance(t, dict):
                return {k: cast(spec[k], t[k]) for k in t}
            return t if t.dim() < 2 or spec.keep_dtype else t.to(cdt)

        return cast(self.param_specs(), params)

    # -- caches -----------------------------------------------------------
    def cache_specs(self, B: int, T: int, mesh=None,
                    rules: Optional[dict] = None) -> Tree:
        """The caches of a global batch of B rows and T slots; with a
        ``mesh`` and its ``rules`` this rank's share of them."""
        specs = tfm.cache_specs(self.cfg, B, T)
        if mesh is None:
            return specs
        from repro_torch.train.sharding import local_specs
        return local_specs(specs, mesh, rules, self.cfg)

    def init_cache(self, B: int, T: int, device: str | torch.device = "cuda",
                   mesh=None, rules: Optional[dict] = None) -> Tree:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)  # zeros / neg-ones: unused
        return tfm.unstack_scan(
            init_params(self.cache_specs(B, T, mesh, rules), gen, dev),
            self.cfg)

    def abstract_cache(self, B: int, T: int, mesh=None,
                       rules: Optional[dict] = None) -> Tree:
        """``init_cache``'s tree as meta tensors."""
        return tfm.unstack_scan(
            abstract_params(self.cache_specs(B, T, mesh, rules)), self.cfg)

    # -- forward ----------------------------------------------------------
    def loss_fn(self, params: Tree, batch: dict, xent_chunk: int = 512,
                tp=None, denom: Optional[torch.Tensor] = None):
        """batch: tokens/targets/loss_mask (B,S) [+ prefix_embed (B,P,M)].
        Returns (loss, metrics): loss = nll + 1e-4 z2 + 1e-2 moe_lb +
        1e-3 moe_z, metrics {nll, z2, moe_lb, moe_z} as f32 scalars. With
        prefix embeddings the loss is on the text positions only. On a mesh
        (``tp``) ``params`` and the rows are this rank's, and the loss is
        the same on every rank of its ``model`` group. nll and z2 are the
        masked sums over the mask's count (at least 1), or over ``denom``
        where given (a DP rank's share of the global count, so that the DP
        mean is the global masked mean: ``TrainSetup``)."""
        cfg = self.cfg
        prefix = batch.get("prefix_embed")
        if prefix is not None and prefix.shape[1] != cfg.n_prefix:
            # the reference fails on the shapes here: the loss would be
            # taken on the wrong positions
            raise ValueError(f"prefix_embed holds {prefix.shape[1]} positions; "
                             f"{cfg.name} takes n_prefix={cfg.n_prefix}")
        hidden, aux, _ = tfm.apply_transformer(
            params, batch["tokens"], cfg=cfg, prefix_embed=prefix, tp=tp)
        if cfg.n_prefix and "prefix_embed" in batch:
            hidden = hidden[:, cfg.n_prefix:]
        nll, z2 = _chunked_xent(params, hidden, batch["targets"],
                                batch["loss_mask"], cfg, xent_chunk, tp, denom)
        aux = {k: torch.as_tensor(v, dtype=torch.float32, device=nll.device)
               for k, v in aux.items()}
        loss = nll + 1e-4 * z2 + 1e-2 * aux["moe_lb"] + 1e-3 * aux["moe_z"]
        return loss, {"nll": nll, "z2": z2, **aux}

    def prefill(self, params: Tree, tokens: torch.Tensor,
                prefix_embed: Optional[torch.Tensor] = None, max_len: int = 0,
                tp=None):
        """Returns (last_token_logits (B,V), cache). ``prefix_embed``
        (B,P,M) goes before the tokens. max_len = cache capacity (>= P +
        prompt length; gives decode headroom). On a mesh (``tp``, a
        ``train.sharding.TPContext``) ``params`` and the rows are this
        rank's, the cache comes out as this rank's share, and the logits
        are whole on every rank."""
        hidden, _, cache = tfm.apply_transformer(
            params, tokens, cfg=self.cfg, prefix_embed=prefix_embed,
            return_cache=True, cache_len=max_len, tp=tp)
        logits = tfm.logits_from_hidden(params, hidden[:, -1:], self.cfg, tp)
        return logits[:, 0], cache

    def decode_step(self, params: Tree, tokens: torch.Tensor,
                    pos: torch.Tensor, cache: Tree, tp=None):
        """tokens: (B,1); pos: (B,). Returns (logits (B,V), cache), the
        cache updated in place."""
        hidden, _, cache = tfm.apply_transformer(
            params, tokens, cfg=self.cfg, positions=pos[:, None], cache=cache,
            tp=tp)
        logits = tfm.logits_from_hidden(params, hidden, self.cfg, tp)
        return logits[:, 0], cache


def _xent_chunk(embed_params: dict, h: torch.Tensor, t: torch.Tensor,
                m: torch.Tensor, cfg, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's masked sums of nll and logz**2; the logits in f32 after
    the softcap, as the reference computes them (under ``tp`` this rank's
    vocab columns, the softcap taken on them first)."""
    lg = unembed(embed_params, h, cfg.tie_embeddings, tp, gather=False)
    lg = softcap(lg, cfg.logit_softcap).float()
    if tp is None:
        logz = torch.logsumexp(lg, dim=-1)                           # (B,c)
        tgt = torch.gather(lg, -1, t.long()[..., None])[..., 0]
    else:
        logz = tp.logsumexp(lg)
        V = lg.shape[-1]                        # this rank's vocab columns
        local = t.long() - tp.r * V
        mine = (local >= 0) & (local < V)
        tgt = torch.gather(lg, -1, torch.where(mine, local, 0)[..., None])[..., 0]
        tgt = tp.reduce(torch.where(mine, tgt, 0.0), torch.float32)
    return ((logz - tgt) * m).sum(), (logz.square() * m).sum()


def _chunked_xent(params: dict, hidden: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor, cfg, chunk: int, tp=None,
                  denom: Optional[torch.Tensor] = None):
    """Sequence-chunked masked cross-entropy and z-loss term. hidden:
    (B,S,M); targets/mask: (B,S). S is padded to a multiple of the chunk
    (pad positions are masked out); each chunk is recomputed in backward.
    The sums are divided by the mask's count (at least 1) or ``denom``."""
    B, S, _ = hidden.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    nll_sum, z2_sum, m_sum = zero, zero, zero
    for i in range(0, S + pad, c):
        sl = slice(i, i + c)
        nll_c, z2_c = torch.utils.checkpoint.checkpoint(
            _xent_chunk, params["embed"], hidden[:, sl], targets[:, sl],
            mask[:, sl], cfg, tp, use_reentrant=False)
        nll_sum = nll_sum + nll_c
        z2_sum = z2_sum + z2_c
        m_sum = m_sum + mask[:, sl].sum()
    if denom is None:
        denom = torch.clamp(m_sum, min=1.0)
    return nll_sum / denom, z2_sum / denom
