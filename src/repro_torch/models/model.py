"""Public model API: init / prefill / decode, the port of
``repro/models/model.py`` for the attention-only kinds."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_params, to_dtype, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # -- params -----------------------------------------------------------
    def param_specs(self) -> Tree:
        """The reference's spec tree (stacked ``scan`` entries)."""
        return tfm.transformer_specs(self.cfg)

    def init(self, seed: int = 0, device: str | torch.device = "cuda") -> Tree:
        """Seeded init on one device; ``scan`` entries come out per period."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tfm.unstack_scan(init_params(self.param_specs(), gen, dev),
                                self.cfg)

    def compute_params(self, params: Tree) -> Tree:
        """Cast every weight matrix to the compute dtype once. The layers
        cast each weight to the compute dtype where they use it (as the
        reference does), so this changes no result; it saves that cast on
        every step. Norm scales (1-D) stay in the param dtype."""
        cdt = to_dtype(self.cfg.compute_dtype)
        return tree_map(lambda t: t.to(cdt) if t.dim() >= 2 else t, params)

    # -- caches -----------------------------------------------------------
    def cache_specs(self, B: int, T: int) -> Tree:
        return tfm.cache_specs(self.cfg, B, T)

    def init_cache(self, B: int, T: int,
                   device: str | torch.device = "cuda") -> Tree:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)  # zeros / neg-ones: unused
        return tfm.unstack_scan(init_params(self.cache_specs(B, T), gen, dev),
                                self.cfg)

    # -- forward ----------------------------------------------------------
    def prefill(self, params: Tree, tokens: torch.Tensor, max_len: int = 0):
        """Returns (last_token_logits (B,V), cache). max_len = cache
        capacity (>= prompt length; gives decode headroom)."""
        hidden, cache = tfm.apply_transformer(
            params, tokens, cfg=self.cfg, return_cache=True, cache_len=max_len)
        logits = tfm.logits_from_hidden(params, hidden[:, -1:], self.cfg)
        return logits[:, 0], cache

    def decode_step(self, params: Tree, tokens: torch.Tensor,
                    pos: torch.Tensor, cache: Tree):
        """tokens: (B,1); pos: (B,). Returns (logits (B,V), cache), the
        cache updated in place."""
        hidden, cache = tfm.apply_transformer(
            params, tokens, cfg=self.cfg, positions=pos[:, None], cache=cache)
        logits = tfm.logits_from_hidden(params, hidden, self.cfg)
        return logits[:, 0], cache
