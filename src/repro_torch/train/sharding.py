"""Logical-axis -> mesh-axis sharding rules, the port of
``repro/train/sharding.py``.

DP over (pod, data); TP/EP over model (the tensor-parallel slice); SP (the
sequence-sharded KV cache) over data for long-context decode (serving on a
mesh). ``make_rules`` is the reference's, rule for rule. Of them the port
applies ``batch`` (which rows of the global batch a rank takes,
``shard_batch``) and ZeRO-1's extra DP split of the moments
(``optim.optimizer.zero1_plan``); the model rules wait for ``model`` > 1.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from repro_torch.launch.mesh import dp_axes  # noqa: F401  (re-exported)


def make_rules(mesh, cfg=None, *, seq_shard_kv: bool = False,
               global_batch: int = 0) -> dict[str, Any]:
    model_n = mesh.shape.get("model", 1)
    dp = dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= mesh.shape[a]
    if global_batch and global_batch % dp_total:
        dp_rule: Any = None   # batch=1 long-context decode: replicate batch,
                              # parallelism comes from SP (kv_seq) + model
    else:
        dp_rule = dp if len(dp) > 1 else (dp[0] if dp else None)

    def maybe_model(size: Optional[int], min_per_shard: int = 1):
        """Shard over model only when evenly divisible; else replicate."""
        if size is None or (size % model_n == 0
                            and size >= model_n * min_per_shard):
            return "model"
        return None

    kv = cfg.n_kv_heads if cfg is not None else None
    return {
        "batch": dp_rule,
        "vocab": "model",
        "embed": None,
        # attention projections are stored flattened (H*D divisible by 16
        # for every assigned arch) -> TP always shards them
        "qkv": "model",
        "kv_flat": "model",
        # per-head axes appear only on caches/activations: shard when a
        # whole head fits per shard (MQA caches replicate — tiny anyway)
        "heads": maybe_model(cfg.n_heads if cfg is not None else None),
        "heads_padded": maybe_model(
            max(cfg.pad_heads_to, cfg.n_heads) if cfg is not None else None),
        "kv_heads": maybe_model(kv),
        "head_dim": None,
        "ffn": "model",
        "expert": "model",
        "expert_ffn": None,
        "capacity": None,
        "inner": "model",
        "rnn": "model",
        "state": None,
        "conv": None,
        "dt": None,
        "layers": None,
        # decode-time KV cache sequence axis: sharded over `data` for
        # long-context (SP decode; batch=1 cannot use DP), else replicated
        "kv_seq": "data" if seq_shard_kv else None,
    }


def batch_rows(mesh, rules, n_rows: int) -> slice:
    """The rows of an ``n_rows`` global batch this rank takes: the whole
    batch where ``rules["batch"]`` replicates it, else its DP position's
    contiguous block (pod-major over the DP axes, as the reference's
    ``P(("pod", "data"))`` places them)."""
    dp = rules["batch"]
    if dp is None:
        return slice(0, n_rows)
    axes = (dp,) if isinstance(dp, str) else tuple(dp)
    n, index = 1, 0
    for a in axes:
        n, index = n * mesh.shape[a], index * mesh.shape[a] + mesh.coords[a]
    if n_rows % n:
        raise ValueError(f"a batch of {n_rows} rows does not split over {n} "
                         f"DP ranks ({axes})")
    per = n_rows // n
    return slice(index * per, (index + 1) * per)


def shard_batch(mesh, rules, batch: dict) -> dict:
    """This rank's rows of every array of the global ``batch`` (numpy or
    tensors, leading axis the batch). Replaces the reference's
    ``batch_shardings``: a rank holds its shard and nothing else."""
    rows = batch_rows(mesh, rules, next(iter(batch.values())).shape[0])
    return {k: (np.ascontiguousarray(v[rows]) if isinstance(v, np.ndarray)
                else v[rows].contiguous()) for k, v in batch.items()}
