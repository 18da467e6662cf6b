"""Serving steps: prefill (builds the KV cache) and one-token decode, the
port of ``repro/train/serve_step.py``.

On a mesh each rank is one process and holds its shard (``init_params``,
or ``convert.params_from_jax(..., mesh=, rules=)``): the rules of ``make_rules`` decide
which slice of every parameter and cache it keeps, and the layers meet over
``model`` (and over ``data`` in SP decode) where GSPMD would insert a
collective (``train.sharding.TPContext``). Batch rows go over the DP axes
where ``global_batch`` divides them (``batch_rows``); otherwise the batch is
replicated and the parallelism comes from ``model`` and, with
``seq_shard_kv``, the sequence-sharded global KV caches (long-context
decode at batch 1: each ``data`` rank holds a slot range of every global
cache). Logits come out whole on every rank.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models.model import Model
from repro_torch.train.sharding import TPContext, batch_rows, make_rules


class ServeSetup:
    def __init__(self, model: Model, mesh=None, *, seq_shard_kv: bool = False,
                 global_batch: int = 0):
        self.model = model
        self.mesh = mesh
        self.rules = self.tp = None
        if mesh is not None:
            self.rules = make_rules(mesh, model.cfg, seq_shard_kv=seq_shard_kv,
                                    global_batch=global_batch)
            batch = self.rules["batch"]
            if seq_shard_kv and batch is not None and "data" in (
                    (batch,) if isinstance(batch, str) else batch):
                raise ValueError(
                    f"seq_shard_kv puts the caches' sequence over data, where "
                    f"a batch of {global_batch} rows is split: serve a batch "
                    f"that data does not divide (the reference's batch-1 "
                    f"long-context decode), or no seq_shard_kv")
            self.tp = TPContext(mesh, self.rules, model.cfg)

    def rows(self, n_rows: int) -> slice:
        """The rows of a global batch this rank serves."""
        if self.mesh is None:
            return slice(0, n_rows)
        return batch_rows(self.mesh, self.rules, n_rows)

    def init_params(self, seed: int, device):
        """Seeded params: this rank's shard of the one-device init."""
        return self.model.init(seed, device, mesh=self.mesh, rules=self.rules)

    def abstract_params(self):
        """This rank's params as meta tensors (the dry run's)."""
        return self.model.abstract_params(self.mesh, self.rules)

    def abstract_cache(self, B: int, T: int):
        """This rank's caches of a global batch of B rows and T slots, as
        meta tensors."""
        return self.model.abstract_cache(B, T, self.mesh, self.rules)

    # -- steps -------------------------------------------------------------
    def prefill_fn(self, max_len: int = 0) -> Callable:
        def prefill(params, batch: dict):
            return self.model.prefill(params, batch["tokens"],
                                      prefix_embed=batch.get("prefix_embed"),
                                      max_len=max_len, tp=self.tp)
        return prefill

    def decode_fn(self) -> Callable:
        def decode(params, cache, batch: dict):
            return self.model.decode_step(params, batch["tokens"],
                                          batch["pos"], cache, tp=self.tp)
        return decode
