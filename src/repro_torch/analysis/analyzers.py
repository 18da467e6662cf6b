"""Pluggable analyzers — string-keyed registry, same pattern as
``repro_torch.transport``'s ``@register_transport``.

An :class:`Analyzer` consumes :class:`~repro_torch.analysis.session.QueryResult`
objects (or raw arrays) via ``update`` and emits a typed
:class:`Summary`. New analysis workloads register a class and are
immediately reachable from ``launch/serve.py --analyzer <name>`` and any
``AnalysisSession`` consumer — no wire-layer changes.

Built-ins:
  * ``running_stats``  — streaming mean/min/max/std/count;
  * ``histogram``      — streaming histogram (range frozen by first batch);
  * ``window_reduce``  — reduction over the last W slices of the ``step``
                         dimension (per-step scalar series kept).
"""
from __future__ import annotations

import abc
import collections
import dataclasses
from typing import Any, Callable, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Summary:
    """Typed analyzer output: who produced it, on how much, and what."""

    analyzer: str
    n_updates: int
    payload: dict[str, Any]

    def __getitem__(self, key: str):
        return self.payload[key]


class Analyzer(abc.ABC):
    """Streaming analysis over query results: ``update`` per result,
    ``summary`` at any point (analyzers are cheap to summarize mid-stream,
    matching the query-while-running model)."""

    name: str = "abstract"

    def __init__(self, **kw):
        if kw:
            raise TypeError(f"analyzer {self.name!r} takes no options {kw}")
        self.n_updates = 0

    def update(self, result) -> None:
        """Consume one QueryResult (or anything array-like)."""
        arr = np.asarray(getattr(result, "array", result))
        self.n_updates += 1
        self._consume(arr)

    @abc.abstractmethod
    def _consume(self, arr: np.ndarray) -> None:
        ...

    @abc.abstractmethod
    def summary(self) -> Summary:
        ...


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class UnknownAnalyzerError(KeyError):
    pass


_REGISTRY: dict[str, type] = {}


def register_analyzer(name: str) -> Callable[[type], type]:
    """Class decorator: ``@register_analyzer("running_stats")``."""

    def deco(cls: type) -> type:
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"analyzer {name!r} already registered "
                             f"({_REGISTRY[name].__name__})")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available() -> tuple[str, ...]:
    """Registered analyzer names, sorted."""
    return tuple(sorted(_REGISTRY))


def get(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownAnalyzerError(
            f"unknown analyzer {name!r}; available: {', '.join(available())}"
        ) from None


def create(name: str, **kw) -> Analyzer:
    """Instantiate a registered analyzer with its options."""
    return get(name)(**kw)


# ---------------------------------------------------------------------------
# built-ins
# ---------------------------------------------------------------------------


@register_analyzer("running_stats")
class RunningStats(Analyzer):
    """Streaming count/mean/min/max/std over every value seen."""

    def __init__(self):
        super().__init__()
        self._n = 0
        self._sum = 0.0
        self._sumsq = 0.0
        self._min = np.inf
        self._max = -np.inf

    def _consume(self, arr: np.ndarray) -> None:
        if arr.size == 0:
            return
        x = arr.astype(np.float64, copy=False)
        self._n += x.size
        self._sum += float(x.sum())
        self._sumsq += float((x * x).sum())
        self._min = min(self._min, float(x.min()))
        self._max = max(self._max, float(x.max()))

    def summary(self) -> Summary:
        n = max(self._n, 1)
        mean = self._sum / n
        var = max(self._sumsq / n - mean * mean, 0.0)
        return Summary(self.name, self.n_updates, {
            "count": self._n, "mean": mean, "std": var ** 0.5,
            "min": self._min if self._n else 0.0,
            "max": self._max if self._n else 0.0,
        })


@register_analyzer("histogram")
class Histogram(Analyzer):
    """Streaming histogram. The bin range is fixed up front (``lo``/``hi``)
    or frozen by the first non-empty batch; later out-of-range values land
    in the edge bins (clipped), so counts always sum to values seen."""

    def __init__(self, bins: int = 16, lo: Optional[float] = None,
                 hi: Optional[float] = None):
        super().__init__()
        if bins < 1:
            raise ValueError("bins must be >= 1")
        if (lo is None) != (hi is None):
            raise ValueError("histogram range needs both lo and hi "
                             "(or neither, to freeze on first batch)")
        if lo is not None and not hi > lo:
            raise ValueError(f"histogram range empty: [{lo}, {hi})")
        self.bins = bins
        self._lo, self._hi = lo, hi
        self._counts = np.zeros(bins, np.int64)

    def _consume(self, arr: np.ndarray) -> None:
        if arr.size == 0:
            return
        x = arr.astype(np.float64, copy=False).reshape(-1)
        if self._lo is None:
            self._lo = float(x.min())
            self._hi = float(x.max())
            if self._hi == self._lo:
                self._hi = self._lo + 1.0
        idx = (x - self._lo) / (self._hi - self._lo) * self.bins
        idx = np.clip(idx.astype(np.int64), 0, self.bins - 1)
        self._counts += np.bincount(idx, minlength=self.bins)

    def summary(self) -> Summary:
        lo = 0.0 if self._lo is None else self._lo
        hi = 1.0 if self._hi is None else self._hi
        edges = np.linspace(lo, hi, self.bins + 1)
        return Summary(self.name, self.n_updates, {
            "counts": self._counts.tolist(), "edges": edges.tolist(),
            "total": int(self._counts.sum()),
        })


@register_analyzer("window_reduce")
class WindowReduce(Analyzer):
    """Reduction over the last ``window`` updates of a per-step series.

    Each ``update`` is one step's worth of data (e.g. the subtar a
    ``watch()`` event announced); it is collapsed to a scalar with
    ``step_op`` and the trailing ``window`` scalars are reduced with
    ``op`` — a running "energy over the last W steps" style diagnostic.
    """

    def __init__(self, window: int = 8, op: str = "mean",
                 step_op: str = "sum"):
        super().__init__()
        if window < 1:
            raise ValueError("window must be >= 1")
        for o in (op, step_op):
            if o not in ("sum", "mean", "max", "min", "std"):
                raise ValueError(f"unknown reduction {o!r}")
        self.window, self.op, self.step_op = window, op, step_op
        self._series: collections.deque = collections.deque(maxlen=window)

    def _consume(self, arr: np.ndarray) -> None:
        if arr.size == 0:
            return
        self._series.append(float(
            getattr(np, self.step_op)(arr.astype(np.float64, copy=False))))

    def summary(self) -> Summary:
        series = list(self._series)
        value = float(getattr(np, self.op)(series)) if series else 0.0
        return Summary(self.name, self.n_updates, {
            "value": value, "series": series, "window": self.window,
            "op": self.op, "step_op": self.step_op,
        })
