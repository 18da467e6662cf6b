"""Convert the reference's parameter (or cache) tree into the port's.

The input is the JAX ``Model.init`` tree with every leaf turned into a numpy
array (``jax.tree.map(np.asarray, params)``); nothing of JAX is imported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import tree_map
from repro_torch.models.transformer import unstack_scan


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> torch, bfloat16 (ml_dtypes) included, bit for bit."""
    a = np.array(a)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Any, cfg, device: str | torch.device = "cuda") -> Any:
    """The reference's tree (stacked ``scan`` entries) -> the port's tree
    (one entry per period). Works for cache trees too."""
    dev = resolve_device(device)
    return unstack_scan(tree_map(lambda a: tensor_from_numpy(a, dev), tree),
                        cfg)
