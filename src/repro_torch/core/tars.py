"""TARS — Typed ARray Schema (Lustosa et al. 2017), the SAVIME data model.

A TAR (Typed ARray) is a named multidimensional array with:
  * dimensions — name + [lower, upper] index range, plus an affine *mapping
    function* (offset + stride·i) supporting non-integer coordinates;
  * attributes — named, typed value fields over the same index space;
  * subtars    — rectangular regions holding the actual payload (dense
    numpy arrays per attribute). Data arrives one subtar at a time
    (the paper's ``load_subtar``), so ingestion is append-only and cheap.

Queries (dimension/range filter, attribute predicate, aggregation) execute
against the set of subtars intersecting the query box. Concurrent readers
are supported (RLock; writers only append subtars).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.tensors import BF16, bf16_to_f32, np_dtype


@dataclasses.dataclass(frozen=True)
class Dimension:
    name: str
    lower: int
    upper: int                      # inclusive
    offset: float = 0.0             # mapping function: coord = offset + i*stride
    stride: float = 1.0

    @property
    def length(self) -> int:
        return self.upper - self.lower + 1

    def to_coord(self, i: np.ndarray | int):
        return self.offset + np.asarray(i, np.float64) * self.stride

    def to_index(self, coord: float) -> int:
        return int(round((coord - self.offset) / self.stride))


@dataclasses.dataclass(frozen=True)
class Attribute:
    name: str
    dtype: str                      # numpy dtype string

    @property
    def np_dtype(self):
        return np_dtype(self.dtype)


@dataclasses.dataclass
class SubTar:
    """Rectangular region [origin, origin+shape) with dense payloads."""
    origin: tuple[int, ...]
    shape: tuple[int, ...]
    data: dict[str, np.ndarray]     # attribute name -> array of `shape`

    def box(self) -> tuple[tuple[int, int], ...]:
        return tuple((o, o + s - 1) for o, s in zip(self.origin, self.shape))

    def intersect(self, lo: tuple[int, ...], hi: tuple[int, ...]):
        """Intersection with query box [lo, hi] (inclusive); None if empty."""
        slo = tuple(max(o, l) for o, l in zip(self.origin, lo))
        shi = tuple(min(o + s - 1, h) for o, s, h in zip(self.origin, self.shape, hi))
        if any(a > b for a, b in zip(slo, shi)):
            return None
        sl = tuple(slice(a - o, b - o + 1)
                   for a, b, o in zip(slo, shi, self.origin))
        return slo, shi, sl


class TAR:
    def __init__(self, name: str, dims: list[Dimension], attrs: list[Attribute]):
        self.name = name
        self.dims = dims
        self.attrs = {a.name: a for a in attrs}
        self.subtars: list[SubTar] = []
        self._lock = threading.RLock()

    # -- ingestion ---------------------------------------------------------
    def load_subtar(self, origin: tuple[int, ...], shape: tuple[int, ...],
                    data: dict[str, np.ndarray]) -> None:
        assert len(origin) == len(self.dims) == len(shape)
        for aname, arr in data.items():
            attr = self.attrs[aname]
            arr = np.asarray(arr, attr.np_dtype).reshape(shape)
            data[aname] = arr
        for d, o, s in zip(self.dims, origin, shape):
            if o < d.lower or o + s - 1 > d.upper:
                raise ValueError(
                    f"subtar box {origin}+{shape} outside dim {d.name} "
                    f"[{d.lower},{d.upper}]")
        with self._lock:
            self.subtars.append(SubTar(tuple(origin), tuple(shape), data))

    # -- queries -----------------------------------------------------------
    def data_box(self) -> Optional[tuple[tuple[int, ...], tuple[int, ...]]]:
        """Bounding box of loaded subtars ((lo...), (hi...)), or None."""
        with self._lock:
            if not self.subtars:
                return None
            boxes = [st.box() for st in self.subtars]
        lo = tuple(min(b[i][0] for b in boxes) for i in range(len(self.dims)))
        hi = tuple(max(b[i][1] for b in boxes) for i in range(len(self.dims)))
        return lo, hi

    def select(self, attr: str, lo: Optional[tuple[int, ...]] = None,
               hi: Optional[tuple[int, ...]] = None) -> np.ndarray:
        """Materialize attribute over query box (missing cells = 0).
        Unbounded queries clip to the loaded-data bounding box (declared
        dims may be huge, e.g. an unbounded `step` dimension)."""
        box = self.data_box()
        if box is None:
            return np.zeros((0,) * len(self.dims), self.attrs[attr].np_dtype)
        lo = box[0] if lo is None else tuple(lo)
        hi = box[1] if hi is None else tuple(hi)
        shape = tuple(h - l + 1 for l, h in zip(lo, hi))
        out = np.zeros(shape, self.attrs[attr].np_dtype)
        with self._lock:
            subtars = list(self.subtars)
        for st in subtars:
            isect = st.intersect(lo, hi)
            if isect is None or attr not in st.data:
                continue
            slo, shi, sl = isect
            dst = tuple(slice(a - l, b - l + 1) for a, b, l in zip(slo, shi, lo))
            out[dst] = st.data[attr][sl]
        return out

    def _values(self, attr: str, lo=None, hi=None) -> np.ndarray:
        """``select`` in a type numpy computes with: bfloat16 bits widened
        to float32."""
        box = self.select(attr, lo, hi)
        return bf16_to_f32(box) if self.attrs[attr].dtype == BF16 else box

    def aggregate(self, attr: str, op: str,
                  lo: Optional[tuple[int, ...]] = None,
                  hi: Optional[tuple[int, ...]] = None) -> float:
        ops: dict[str, Callable] = {
            "sum": np.sum, "mean": np.mean, "max": np.max, "min": np.min,
            "std": np.std, "count": np.size,
        }
        return float(ops[op](self._values(attr, lo, hi)))

    def filter(self, attr: str, pred: Callable[[np.ndarray], np.ndarray],
               lo=None, hi=None) -> np.ndarray:
        """Returns (n_hits, ndim+1) array: index coords + value per hit."""
        box = self._values(attr, lo, hi)
        lo = tuple(d.lower for d in self.dims) if lo is None else tuple(lo)
        idx = np.argwhere(pred(box))
        vals = box[tuple(idx.T)]
        return np.concatenate([idx + np.asarray(lo), vals[:, None]], axis=1)

    def cells(self) -> int:
        with self._lock:
            return int(sum(np.prod(st.shape) for st in self.subtars))

    def nbytes(self) -> int:
        with self._lock:
            return int(sum(a.nbytes for st in self.subtars
                           for a in st.data.values()))
