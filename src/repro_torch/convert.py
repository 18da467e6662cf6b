"""Convert between the reference's trees and the port's.

The reference's side is a JAX tree with every leaf turned into a numpy array
(``jax.tree.map(np.asarray, tree)``); nothing of JAX is imported. Its
``scan`` entries are stacked on a leading periods axis, where the port holds
a list with one tree per period.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import tree_map
from repro_torch.models.transformer import unstack_scan
from repro_torch.tensors import to_host


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> torch, bfloat16 (ml_dtypes) included, bit for bit."""
    a = np.array(a)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Any, cfg, device: str | torch.device = "cuda",
                    mesh=None, rules: Optional[dict] = None) -> Any:
    """The reference's tree (stacked ``scan`` entries) -> the port's tree
    (one entry per period). Works for cache trees too. With a ``mesh`` and
    its ``rules``, this rank's shard of a parameter tree
    (``train.sharding.shard_tree``)."""
    dev = resolve_device(device)
    if mesh is not None:
        from repro_torch.models.transformer import transformer_specs
        from repro_torch.train.sharding import shard_tree
        tree = shard_tree(tree, transformer_specs(cfg), mesh, rules, cfg)
    return unstack_scan(tree_map(lambda a: tensor_from_numpy(a, dev), tree),
                        cfg)


def train_state_from_jax(state: Any, cfg, device: str | torch.device = "cuda") -> dict:
    """The reference's train state ({"params", "opt": {"mu", "nu", "count"},
    "step"} as numpy) -> the port's: params and moments with per-period
    ``scan`` entries, count and step as int32 scalars."""
    dev = resolve_device(device)
    opt = state["opt"]
    return {"params": params_from_jax(state["params"], cfg, dev),
            "opt": {"mu": params_from_jax(opt["mu"], cfg, dev),
                    "nu": params_from_jax(opt["nu"], cfg, dev),
                    "count": tensor_from_numpy(opt["count"], dev)},
            "step": tensor_from_numpy(state["step"], dev)}


def to_reference_layout(tree: Any) -> Any:
    """A port tree -> host numpy in the reference's layout: each list (a
    ``scan`` entry's periods) stacked on a new leading axis, every leaf a
    copy that no later in-place update of the tensor reaches. A bfloat16
    leaf comes out as its bits, in uint16 (``repro_torch.tensors``). The
    inverse of ``params_from_jax`` and ``train_state_from_jax``."""
    if isinstance(tree, dict):
        return {k: to_reference_layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        per = [to_reference_layout(t) for t in tree]
        return _stack(per)
    a = to_host(tree)
    return a.copy() if tree.device.type == "cpu" else a


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
