"""Typed query layer — the ONLY place SAVIME mini-language text is built.

Every statement the repo sends to SAVIME is a frozen dataclass with a
``compile()`` method; callers construct statements (or use the fluent
builder below) and hand them to :class:`~repro_torch.analysis.AnalysisSession`
or any ``run_savime``-bearing transport. Raw query strings are wire
plumbing, not an API: grep for ``compile`` — this module is the compiler.

    from repro_torch.analysis import tar
    stmt = tar("velocity").attr("v").range((0, 0, 0), (10, 10, 10)).mean()
    stmt.compile()   # -> 'aggregate(velocity, v, mean, "0,0,0", "10,10,10")'

DDL statements take the TARS schema types (``repro_torch.core.tars.Dimension``
/ ``Attribute``) so the client-side description and the engine-side
catalogue cannot drift apart. They are duck-typed here (``name`` /
``lower`` / ``upper`` / ``offset`` / ``stride``, ``name`` / ``dtype``)
rather than imported: this module must stay a leaf so every layer —
including ``repro_torch.core`` itself — can compile through it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

AGG_OPS = ("sum", "mean", "max", "min", "std", "count")


def _point(p: Sequence[int]) -> str:
    return ",".join(str(int(x)) for x in p)


def _dim_spec(d: Any) -> str:
    """``d`` is a ``repro_torch.core.tars.Dimension`` (duck-typed)."""
    spec = f"{d.name}:{d.lower}:{d.upper}"
    if d.offset != 0.0 or d.stride != 1.0:
        spec += f":{d.offset}:{d.stride}"
    return spec


def _attr_spec(a: Any) -> str:
    """``a`` is a ``repro_torch.core.tars.Attribute`` (duck-typed)."""
    return f"{a.name}:{a.dtype}"


def _check_box(lo, hi) -> None:
    if (lo is None) != (hi is None):
        raise ValueError("range needs both lo and hi (or neither)")
    if lo is not None and len(lo) != len(hi):
        raise ValueError(f"range rank mismatch: {lo} vs {hi}")


class Statement:
    """Base for all typed statements. ``kind`` feeds per-query stats;
    ``idempotent`` tells the session whether a lost-reply retry is safe
    (re-running ``create_tar``/``load_subtar`` after the server already
    applied it fails or double-loads)."""

    idempotent = False

    @property
    def kind(self) -> str:
        return type(self).__name__.lower()

    def compile(self) -> str:  # pragma: no cover - subclasses override
        raise NotImplementedError

    def __str__(self) -> str:
        return self.compile()


# ---------------------------------------------------------------------------
# DDL / ingestion statements
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CreateTar(Statement):
    """``create_tar`` — declare a TAR from TARS schema objects."""

    tar: str
    dims: tuple[Any, ...]       # repro_torch.core.tars.Dimension objects
    attrs: tuple[Any, ...]      # repro_torch.core.tars.Attribute objects

    def compile(self) -> str:
        dims = ", ".join(_dim_spec(d) for d in self.dims)
        attrs = ", ".join(_attr_spec(a) for a in self.attrs)
        return f'create_tar({self.tar}, "{dims}", "{attrs}")'


@dataclasses.dataclass(frozen=True)
class LoadSubtar(Statement):
    """``load_subtar`` — attach an ingested dataset as a subtar payload."""

    tar: str
    dataset: str
    origin: tuple[int, ...]
    shape: tuple[int, ...]
    attr: str

    def __post_init__(self):
        if len(self.origin) != len(self.shape):
            raise ValueError(f"origin/shape rank mismatch: "
                             f"{self.origin} vs {self.shape}")

    def compile(self) -> str:
        return (f'load_subtar({self.tar}, {self.dataset}, '
                f'"{_point(self.origin)}", "{_point(self.shape)}", '
                f'{self.attr})')


@dataclasses.dataclass(frozen=True)
class DropTar(Statement):
    idempotent = True               # dropping a dropped tar is a no-op

    tar: str

    def compile(self) -> str:
        return f"drop_tar({self.tar})"


# ---------------------------------------------------------------------------
# analytical statements
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Select(Statement):
    """Dimension/range filter — the paper's §6 "filtering stored data by
    dimensions and by range"."""

    idempotent = True

    tar: str
    attr: str
    lo: Optional[tuple[int, ...]] = None
    hi: Optional[tuple[int, ...]] = None

    def __post_init__(self):
        _check_box(self.lo, self.hi)

    def compile(self) -> str:
        if self.lo is not None:
            return (f'select({self.tar}, {self.attr}, '
                    f'"{_point(self.lo)}", "{_point(self.hi)}")')
        return f"select({self.tar}, {self.attr})"


@dataclasses.dataclass(frozen=True)
class Aggregate(Statement):
    idempotent = True

    tar: str
    attr: str
    op: str
    lo: Optional[tuple[int, ...]] = None
    hi: Optional[tuple[int, ...]] = None

    def __post_init__(self):
        if self.op not in AGG_OPS:
            raise ValueError(f"unknown aggregate op {self.op!r}; "
                             f"one of {', '.join(AGG_OPS)}")
        _check_box(self.lo, self.hi)

    def compile(self) -> str:
        if self.lo is not None:
            return (f'aggregate({self.tar}, {self.attr}, {self.op}, '
                    f'"{_point(self.lo)}", "{_point(self.hi)}")')
        return f"aggregate({self.tar}, {self.attr}, {self.op})"


@dataclasses.dataclass(frozen=True)
class Window(Statement):
    """Windowed reduction over one dimension (by default the leading
    ``step`` dimension every sink-created TAR carries).

    The mini-language has no window operator, so this compiles to the
    underlying ``select`` and reduces client-side in ``finalize``: the
    trailing ``size`` slices along ``dim`` are reduced with ``op``,
    collapsing that axis (e.g. the mean field over the last 8 steps).
    """

    idempotent = True

    tar: str
    attr: str
    op: str = "mean"
    dim: int = 0
    size: int = 8
    lo: Optional[tuple[int, ...]] = None
    hi: Optional[tuple[int, ...]] = None

    def __post_init__(self):
        if self.op not in ("sum", "mean", "max", "min", "std"):
            raise ValueError(f"unknown window op {self.op!r}")
        if self.size < 1:
            raise ValueError("window size must be >= 1")
        _check_box(self.lo, self.hi)

    def compile(self) -> str:
        return Select(self.tar, self.attr, self.lo, self.hi).compile()

    def finalize(self, raw):
        arr = np.asarray(raw)
        if arr.ndim == 0 or arr.size == 0:
            return arr
        win = np.moveaxis(arr, self.dim, 0)[-self.size:]
        return getattr(np, self.op)(win, axis=0)


# ---------------------------------------------------------------------------
# fluent builder
# ---------------------------------------------------------------------------


class QueryBuilder:
    """Fluent construction of analytical statements:

        tar("velocity").attr("v").range((0,0,0), (10,10,10)).mean()

    Terminal methods (``select`` / ``mean`` / ... / ``window``) return the
    frozen statement dataclass; the builder itself is cheap and single-use.
    """

    def __init__(self, tar_name: str):
        self._tar = tar_name
        self._attr: Optional[str] = None
        self._lo: Optional[tuple[int, ...]] = None
        self._hi: Optional[tuple[int, ...]] = None

    def attr(self, name: str) -> "QueryBuilder":
        self._attr = name
        return self

    def range(self, lo: Sequence[int], hi: Sequence[int]) -> "QueryBuilder":
        _check_box(tuple(lo), tuple(hi))
        self._lo, self._hi = tuple(int(x) for x in lo), \
            tuple(int(x) for x in hi)
        return self

    def _need_attr(self) -> str:
        if self._attr is None:
            raise ValueError(f"query on tar {self._tar!r} needs .attr(name)")
        return self._attr

    # -- terminals ------------------------------------------------------
    def select(self) -> Select:
        return Select(self._tar, self._need_attr(), self._lo, self._hi)

    def aggregate(self, op: str) -> Aggregate:
        return Aggregate(self._tar, self._need_attr(), op, self._lo, self._hi)

    def sum(self) -> Aggregate:
        return self.aggregate("sum")

    def mean(self) -> Aggregate:
        return self.aggregate("mean")

    def max(self) -> Aggregate:
        return self.aggregate("max")

    def min(self) -> Aggregate:
        return self.aggregate("min")

    def std(self) -> Aggregate:
        return self.aggregate("std")

    def count(self) -> Aggregate:
        return self.aggregate("count")

    def window(self, size: int = 8, op: str = "mean", dim: int = 0) -> Window:
        return Window(self._tar, self._need_attr(), op, dim, size,
                      self._lo, self._hi)


def tar(name: str) -> QueryBuilder:
    """Entry point of the fluent builder (mirrors SQL's FROM)."""
    return QueryBuilder(name)
