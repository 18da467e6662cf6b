"""Data pipeline: synthetic-but-structured LM batches and the host->device
feed, the port of ``repro/data/pipeline.py``.

Synthetic corpus: Zipf-distributed tokens with injected repeated n-grams so
a real model shows a falling loss within a few hundred steps. ``SyntheticLM``
is the reference's numpy code, copied: for the same config and seed it
gives the reference's batches array for array. ``batch_to_device`` takes the
place of the reference's ``device_put_batch`` on one device, and
``device_put_batch`` on a mesh: every rank draws the same global batch from
the same seed and keeps its DP rows, so a DP step sees the rows the 1x1
step sees.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train.sharding import shard_batch


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    n_motifs: int = 64          # repeated n-grams (learnable structure)
    motif_len: int = 8
    motif_rate: float = 0.3
    n_prefix: int = 0
    d_model: int = 0            # for prefix_embed stub (vlm/audio)


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        v = max(cfg.vocab_size - 2, 2)
        # zipf over a permuted alphabet
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self.p = p / p.sum()
        self.perm = self.rng.permutation(v)
        self.motifs = self.rng.integers(
            0, v, size=(cfg.n_motifs, cfg.motif_len))

    def _sample_tokens(self, n: int) -> np.ndarray:
        c = self.cfg
        toks = self.perm[np.searchsorted(
            np.cumsum(self.p), self.rng.random(n), side="right").clip(0, len(self.p) - 1)]
        # splice motifs at random positions
        n_splice = int(n * c.motif_rate / c.motif_len)
        if n_splice:
            pos = self.rng.integers(0, max(n - c.motif_len, 1), n_splice)
            ids = self.rng.integers(0, c.n_motifs, n_splice)
            for p_, i_ in zip(pos, ids):
                toks[p_:p_ + c.motif_len] = self.motifs[i_]
        return toks.astype(np.int32)

    def batches(self) -> Iterator[dict[str, np.ndarray]]:
        c = self.cfg
        while True:
            flat = self._sample_tokens(c.global_batch * (c.seq_len + 1))
            flat = flat.reshape(c.global_batch, c.seq_len + 1)
            batch = {
                "tokens": flat[:, :-1],
                "targets": flat[:, 1:],
                "loss_mask": np.ones((c.global_batch, c.seq_len), np.float32),
            }
            if c.n_prefix:
                batch["prefix_embed"] = self.rng.standard_normal(
                    (c.global_batch, c.n_prefix, c.d_model)).astype(np.float32) * 0.02
            yield batch


def batch_to_device(batch: dict, device: str | torch.device = "cuda") -> dict:
    """numpy batch -> tensors on ``device`` (CUDA unless the CPU is asked
    for), dtypes kept."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def device_put_batch(batch: dict, mesh, rules,
                     device: str | torch.device = "cuda",
                     microbatches: int = 1) -> dict:
    """This rank's rows of the global numpy ``batch`` (``make_rules``'
    ``batch`` rule; with the step's ``microbatches``, its share of each,
    ``sharding.batch_rows``) as tensors on ``device``."""
    return batch_to_device(shard_batch(mesh, rules, batch, microbatches), device)
