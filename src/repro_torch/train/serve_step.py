"""Serving steps: prefill (builds the KV cache) and one-token decode, the
port of ``repro/train/serve_step.py`` on one device (no shardings)."""
from __future__ import annotations

from typing import Callable

from repro_torch.models.model import Model


class ServeSetup:
    def __init__(self, model: Model):
        self.model = model

    def prefill_fn(self, max_len: int = 0) -> Callable:
        def prefill(params, batch: dict):
            return self.model.prefill(params, batch["tokens"],
                                      prefix_embed=batch.get("prefix_embed"),
                                      max_len=max_len)
        return prefill

    def decode_fn(self) -> Callable:
        def decode(params, cache, batch: dict):
            return self.model.decode_step(params, batch["tokens"],
                                          batch["pos"], cache)
        return decode
