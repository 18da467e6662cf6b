"""Torch tensors at the edge of the data plane, where the reference sees
jax or numpy arrays: the numpy dtype name that the DDL and the wire carry,
and the host copy that stands where the reference calls ``np.asarray``."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype: "float32", "bfloat16", "int64",
    ... (``str(t.dtype)`` gives "torch.float32")."""
    return str(t.dtype).removeprefix("torch.")


def to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of the tensor (a view of it when it lies on the CPU)."""
    if t.dtype == torch.bfloat16:
        raise ValueError("a bfloat16 tensor has no numpy dtype: stage it with "
                         "codec='int8-block', or cast it first")
    return t.detach().cpu().numpy()


def host_array(x: Any) -> np.ndarray:
    """``np.asarray`` that also takes a torch tensor on any device."""
    return to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)
