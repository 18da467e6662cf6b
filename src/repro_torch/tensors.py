"""Torch tensors at the edge of the data plane, where the reference sees
jax or numpy arrays: the numpy dtype name that the DDL and the wire carry,
and the host copy that stands where the reference calls ``np.asarray``.

numpy has no bfloat16 of its own; the reference gets one from ``ml_dtypes``,
which jax imports. The port imports neither, so it has one numpy-only
representation of bfloat16, used everywhere in its data plane: the values'
bits as ``uint16`` (the same 2 bytes a value the reference's arrays hold),
under the wire and DDL name "bfloat16". Where numpy must compute on such
values (the codec's quantize and decode, SAVIME's aggregates, a query's
result) they are widened to float32, which is exact; a float32 result goes
back to bfloat16 by rounding to nearest even, as ``ml_dtypes`` and torch do.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

BF16 = "bfloat16"


def dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype: "float32", "bfloat16", "int64",
    ... (``str(t.dtype)`` gives "torch.float32")."""
    return str(t.dtype).removeprefix("torch.")


def np_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds values of the wire dtype ``name``:
    "bfloat16" values are held as their bits, in uint16."""
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16) widened to float32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to nearest even bfloat16, as bits (uint16). A
    NaN stays a (quiet) NaN."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16
            ).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        bits[nan] = ((u[nan] >> 16) | 0x40).astype(np.uint16)
    return bits


def to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of the tensor (a view of it when it lies on the CPU); a
    bfloat16 tensor as its bits, in uint16."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def host_array(x: Any) -> np.ndarray:
    """``np.asarray`` that also takes a torch tensor on any device."""
    return to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)
