"""Codec ABC + string-keyed registry for egress-path data reduction.

A codec shrinks dataset bytes *before* they cross the staging hop
(Catalyst-ADIOS2's "reduce at the producer" rule).  Codecs are symmetric:
``encode`` runs client-side (optionally on-device), ``decode`` runs at the
staging server — either at ingest (default, full fidelity to SAVIME) or
lazily at forward/query time (``decode_at="query"``).

The registry mirrors ``transport/base.py`` and ``analysis/analyzers.py``:
string-keyed, ``@register_codec`` on the class, ``create()`` returns a fresh
stateful instance (delta chains live inside the instance, one per session).
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.tensors import np_dtype as _wire_dtype


class CodecError(Exception):
    """Base class for codec failures."""


class UnknownCodecError(CodecError, KeyError):
    def __init__(self, name: str):
        super().__init__(f"unknown codec {name!r}; available: {available()}")
        self.name = name


class CodecOrderError(CodecError):
    """A chained codec received a delta whose base has not been seen yet.

    Carries enough context for the staging server to *park* the dataset and
    retry once the base arrives (io_threads > 1 reorders write_reqs).
    """

    def __init__(self, key: str, base: int, have: int):
        super().__init__(
            f"chained decode out of order for {key!r}: need base seq {base}, "
            f"decoder is at seq {have}")
        self.key = key
        self.base = base
        self.have = have


# Numpy dtypes for the wire-level dtype strings used by write_req/SAVIME.
_DTYPES = {
    "double": np.float64, "float": np.float32, "float64": np.float64,
    "float32": np.float32, "float16": np.float16,
    "int64": np.int64, "int32": np.int32, "int16": np.int16,
    "int8": np.int8, "uint8": np.uint8, "char": np.uint8,
}


def np_dtype(dtype: str):
    """Map a wire dtype string to a numpy dtype, or None if unknown
    ("bfloat16" to uint16, the port's representation of its bits)."""
    if dtype in _DTYPES:
        return np.dtype(_DTYPES[dtype])
    try:
        return _wire_dtype(dtype)
    except TypeError:
        return None


def as_bytes_array(data) -> np.ndarray:
    """View any bytes-like / ndarray input as a flat uint8 array (no copy)."""
    if isinstance(data, np.ndarray):
        a = np.ascontiguousarray(data)
        return a.view(np.uint8).reshape(-1)
    return np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)


class Codec(abc.ABC):
    """Encode/decode one dataset's bytes.

    Class attributes:
      name      registry key (set by ``@register_codec``).
      lossless  decode(encode(x)) is byte-identical to x.
      chained   encode output depends on the previous dataset of the same
                key (tar/dataset name); chained codecs must decode at ingest
                and in sequence order (``CodecOrderError`` signals a gap).

    Instances are stateful and single-session: one encoder per Communicator,
    one decoder per StagingServer.  ``meta`` must stay small and JSON-safe —
    it rides the write_req/stripe_open/batch_open control frame; bulk side
    data (e.g. scales) belongs inside the payload.
    """

    name: str = ""
    lossless: bool = True
    chained: bool = False

    @abc.abstractmethod
    def encode(self, data, *, dtype: str = "uint8",
               key: str = "") -> Tuple[Any, Dict[str, Any]]:
        """Return ``(payload, meta)``; payload is bytes-like/uint8 array."""

    @abc.abstractmethod
    def decode(self, payload, meta: Dict[str, Any], *,
               key: str = "") -> np.ndarray:
        """Return the raw bytes as a flat uint8 array."""

    def reset(self, key: str = "") -> None:
        """Forget any cross-dataset encoder state for ``key``.

        Called before a *replayed* write (journal recovery): a chained
        codec must emit a self-contained frame (``base=None``) because
        the peer's decode chain may or may not have seen the original.
        Stateless codecs need nothing — the default is a no-op."""


_REGISTRY: Dict[str, type] = {}


def register_codec(name: str):
    """Class decorator: ``@register_codec("delta-rle")``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available() -> list:
    return sorted(_REGISTRY)


def get(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownCodecError(name) from None


def create(name: str, **kwargs) -> Codec:
    """Instantiate a fresh (stateful) codec by registry name."""
    return get(name)(**kwargs)
