"""Scatter-gather query router — one analytical answer over N backends.

A tar sharded across the pool (each dataset/subtar loaded into exactly
one backend's SAVIME by ring placement) must still answer a single
:class:`~repro_torch.analysis.AnalysisSession`-shaped query. This module holds
the pure merge functions plus :class:`RouterSession`, the
AnalysisSession-compatible front the gateway's ``run_savime`` op and
analytical clients both ride.

Merge strategy, chosen for *byte-identical* parity with the N=1 run
(the acceptance bar — "recombines exactly" must mean bit-equal floats,
not merely close):

  * ``select`` — each backend materializes the *same* query box (its
    missing cells are zero-filled, exactly as a single server zero-fills
    them); the box-shaped parts are summed elementwise.  Subtars are
    placed disjointly (each dataset lives on one backend), so every cell
    is non-zero in at most one part and the sum *is* the overlay — no
    float reordering anywhere.
  * ``sum`` / ``mean`` / ``std`` / ``count`` — computed by applying the
    single-server reduction (``float(np_op(...))``) to the merged select,
    not by recombining per-backend scalars: ``sum(A) + sum(B)`` changes
    the pairwise-summation tree and can drift in the last bit, while
    ``np.sum(A + B)`` reduces the identical array a single server would.
  * ``min`` / ``max`` — scalar merge of per-backend aggregates over the
    *resolved* query box (never each backend's own data box: the
    single-server answer includes the zero-filled gaps, so every backend
    must see the same box). Float min/max is exact, order-free.
  * unbounded queries — resolved against the union of per-backend data
    boxes (the new ``data_box`` engine op), which equals the single
    server's clip box.
  * histograms — analyzer summaries with identical edges merge by
    summing counts (:func:`merge_histograms`).
  * ``watch()`` — :class:`MultiSubscription` selects across one push
    connection per backend and yields events as they arrive.
"""
from __future__ import annotations

import select as _select
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.core import wire
from repro_torch.core.savime import SavimeClient, SavimeError, _parse_call
from repro_torch.analysis.query import Aggregate, Select, Statement
from repro_torch.analysis.session import (AnalysisStats, QueryResult,
                                    SubscriptionClosed, Subscription,
                                    SubtarEvent)

Box = tuple[tuple[int, ...], tuple[int, ...]]


# ---------------------------------------------------------------------------
# pure merge functions
# ---------------------------------------------------------------------------


def backend_data_box(cli: SavimeClient, tar: str) -> Optional[Box]:
    """One backend's loaded bounding box for ``tar`` (None = no data,
    including "tar unknown here" — a backend that never saw the DDL)."""
    try:
        box = cli.run(f"data_box({tar})")
    except SavimeError:
        return None
    if not box:
        return None
    return tuple(box[0]), tuple(box[1])


def union_box(boxes: Sequence[Optional[Box]]) -> Optional[Box]:
    """Bounding box of the per-backend boxes — equals the data box a
    single server holding every subtar would clip unbounded queries to."""
    boxes = [b for b in boxes if b]
    if not boxes:
        return None
    nd = len(boxes[0][0])
    lo = tuple(min(b[0][i] for b in boxes) for i in range(nd))
    hi = tuple(max(b[1][i] for b in boxes) for i in range(nd))
    return lo, hi


def _first_answer(clis: Sequence[SavimeClient], q: str):
    """Run ``q`` on backends in order until one answers. In a sharded
    pool "no tar here" is membership, not failure — only surface an
    error when *no* backend can answer, preferring a substantive error
    (e.g. min over an empty tar) over a membership miss."""
    errs: list[SavimeError] = []
    for cli in clis:
        try:
            return cli.run(q)
        except SavimeError as e:
            errs.append(e)
    substantive = [e for e in errs if not str(e).startswith("no tar")]
    raise (substantive[0] if substantive else errs[-1])


def gather_select(clis: Sequence[SavimeClient], tar: str, attr: str,
                  lo=None, hi=None) -> np.ndarray:
    """Merged ``select`` over every backend (overlay-by-sum; see module
    docstring for why this is byte-identical to the N=1 run)."""
    if lo is None:
        box = union_box([backend_data_box(c, tar) for c in clis])
        if box is None:
            # no subtar anywhere: delegate so the typed empty result
            # (dtype + 0-size shape) matches the single server exactly
            return np.asarray(_first_answer(clis, Select(tar, attr).compile()))
        lo, hi = box
    lo, hi = tuple(lo), tuple(hi)
    q = Select(tar, attr, lo, hi).compile()
    shape = tuple(h - l + 1 for l, h in zip(lo, hi))
    merged: Optional[np.ndarray] = None
    typed_empty: Optional[np.ndarray] = None
    for cli in clis:
        try:
            part = np.asarray(cli.run(q))
        except SavimeError:
            continue            # this backend never saw the tar's DDL

        if part.shape != shape:
            typed_empty = part  # empty-tar backends answer 0-size typed
            continue
        merged = part.copy() if merged is None else merged + part
    if merged is not None:
        return merged
    if typed_empty is not None:
        return typed_empty
    return np.asarray(_first_answer(clis, q))   # surface the right error


def gather_aggregate(clis: Sequence[SavimeClient], tar: str, attr: str,
                     op: str, lo=None, hi=None) -> float:
    """Merged ``aggregate`` (exactness per the module docstring)."""
    if lo is None:
        box = union_box([backend_data_box(c, tar) for c in clis])
        if box is None:
            # empty everywhere: raise/return whatever one server would
            return float(_first_answer(clis,
                                       Aggregate(tar, attr, op).compile()))
        lo, hi = box
    lo, hi = tuple(lo), tuple(hi)
    if op in ("sum", "mean", "std", "count"):
        merged = gather_select(clis, tar, attr, lo, hi)
        np_op = {"sum": np.sum, "mean": np.mean, "std": np.std,
                 "count": np.size}[op]
        return float(np_op(merged))
    if op not in ("min", "max"):
        raise SavimeError(f"unknown aggregate op {op!r}")
    q = Aggregate(tar, attr, op, lo, hi).compile()
    parts: list[float] = []
    for cli in clis:
        try:
            parts.append(float(cli.run(q)))
        except SavimeError:
            continue        # backend holds no data for this tar
    if not parts:
        return float(_first_answer(clis, q))   # surface the right error
    return float(max(parts) if op == "max" else min(parts))


def merge_histograms(summaries) -> dict:
    """Merge ``histogram`` analyzer payloads computed per backend: counts
    add bin-wise when every summary shares the same edges (fix the range
    up front — ``Histogram(bins, lo, hi)`` — so they do)."""
    payloads = [getattr(s, "payload", s) for s in summaries]
    if not payloads:
        return {"counts": [], "edges": [], "total": 0}
    edges = payloads[0]["edges"]
    for p in payloads[1:]:
        if p["edges"] != edges:
            raise ValueError(
                "cannot merge histograms with different edges; construct "
                "them with an explicit (lo, hi) range")
    counts = np.sum([p["counts"] for p in payloads], axis=0)
    return {"counts": counts.tolist(), "edges": list(edges),
            "total": int(counts.sum())}


def route_query(clis: Sequence[SavimeClient], q: str,
                place: Optional[Callable[[str], Optional[int]]] = None):
    """Route one compiled mini-language query across ``clis``.

    DDL (``create_tar``/``drop_tar``) fans to every backend so any of
    them can host any subtar; ``load_subtar`` runs where its dataset was
    ingested (``place(dataset) -> client index`` hint first, then the
    rest — the dataset lives on exactly one backend); reads merge via
    the gather functions above.
    """
    if not clis:
        raise RuntimeError("no live backends to route to")
    fn, args = _parse_call(q)
    if fn in ("create_tar", "drop_tar"):
        res = None
        for cli in clis:
            res = cli.run(q)
        return res
    if fn == "load_subtar":
        dataset = args[1] if len(args) > 1 else ""
        order = list(range(len(clis)))
        if place is not None:
            i = place(dataset)
            if i is not None and 0 <= i < len(clis):
                order.remove(i)
                order.insert(0, i)
        last: Optional[SavimeError] = None
        for i in order:
            try:
                return clis[i].run(q)
            except SavimeError as e:
                last = e
        raise last if last is not None else SavimeError("no backends")

    def _box(i: int):
        if len(args) > i and args[i]:
            return tuple(int(x) for x in args[i].split(","))
        return None

    if fn == "select":
        return gather_select(clis, args[0], args[1], _box(2), _box(3))
    if fn == "aggregate":
        return gather_aggregate(clis, args[0], args[1], args[2],
                                _box(3), _box(4))
    if fn == "data_box":
        box = union_box([backend_data_box(c, args[0]) for c in clis])
        return None if box is None else [list(box[0]), list(box[1])]
    # membership-independent ops (list_tars, ...) answer from one backend
    return clis[0].run(q)


# ---------------------------------------------------------------------------
# multiplexed subscriptions
# ---------------------------------------------------------------------------


class MultiSubscription:
    """``watch()`` over a sharded tar: one push connection per backend,
    events interleaved in arrival order. Iteration semantics mirror
    :class:`~repro_torch.analysis.session.Subscription` (ends after
    ``max_events`` events or a ``timeout`` wait with nothing arriving)."""

    def __init__(self, addrs: Sequence[str], tar: str = "", *,
                 timeout: Optional[float] = None,
                 max_events: Optional[int] = None):
        self.tar = tar
        self.timeout = timeout
        self.max_events = max_events
        self.n_events = 0
        self.subs: list[Subscription] = []
        try:
            for a in addrs:
                self.subs.append(Subscription(a, tar))
        except BaseException:
            self.close()
            raise

    def poll(self, timeout: Optional[float] = None) -> Optional[SubtarEvent]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            live = {s._sock: s for s in self.subs if not s._closed}
            if not live:
                return None
            remaining = None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)
            ready, _, _ = _select.select(list(live), [], [], remaining)
            for sock in ready:
                try:
                    ev = live[sock].poll(0)
                except SubscriptionClosed:
                    continue        # one backend gone; survivors keep going
                if ev is not None:
                    self.n_events += 1
                    return ev
            if deadline is not None and time.monotonic() >= deadline:
                return None
            if not ready and remaining is None:
                return None      # select woke with nothing: all gone

    def __iter__(self) -> Iterator[SubtarEvent]:
        return self

    def __next__(self) -> SubtarEvent:
        if self.max_events is not None and self.n_events >= self.max_events:
            raise StopIteration
        ev = self.poll(self.timeout)
        if ev is None:
            raise StopIteration
        return ev

    def close(self) -> None:
        for s in self.subs:
            s.close()

    def __enter__(self) -> "MultiSubscription":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# session front
# ---------------------------------------------------------------------------


class RouterSession:
    """AnalysisSession-compatible scatter-gather front.

    Point it at the pool directly (``savime_addrs=[...]``) or at a
    gateway (``gateway_addr=...`` — the backend list and the placement
    hint come from the gateway's ring). Surface mirrors
    :class:`~repro_torch.analysis.AnalysisSession`: ``execute`` /
    ``execute_all`` / ``watch`` / ``server_stats`` / typed
    :class:`QueryResult`s / :class:`AnalysisStats`.
    """

    def __init__(self, savime_addrs: Optional[Sequence[str]] = None, *,
                 gateway_addr: Optional[str] = None,
                 label: Optional[str] = None):
        if (savime_addrs is None) == (gateway_addr is None):
            raise ValueError("RouterSession needs exactly one of "
                             "savime_addrs= or gateway_addr=")
        self._ring = None
        if gateway_addr is not None:
            from repro_torch.gateway.ring import HashRing   # local: leaf import
            sock = wire.connect(gateway_addr)
            try:
                h, _ = wire.request(sock, {"op": "ring"})
            finally:
                sock.close()
            if not h.get("ok"):
                raise RuntimeError(f"gateway ring fetch failed: "
                                   f"{h.get('error')}")
            self._ring = HashRing.decode(h["ring"])
            savime_addrs = [n.savime_addr for n in self._ring.nodes]
            if not all(savime_addrs):
                raise RuntimeError("gateway ring carries no analytical "
                                   "endpoints (savime_addr)")
        self.addrs = list(savime_addrs)
        self.stats = AnalysisStats(
            endpoint=label or f"router[{len(self.addrs)}]")
        self._clis: list[SavimeClient] = []
        self._opened = False
        self._closed = False

    # -- lifecycle ------------------------------------------------------
    def open(self) -> "RouterSession":
        if self._opened:
            return self
        self._clis = [SavimeClient(a) for a in self.addrs]
        self._opened = True
        return self

    def __enter__(self) -> "RouterSession":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._closed = True
        for cli in self._clis:
            cli.close()
        self._clis = []

    # -- execution ------------------------------------------------------
    def _place_hint(self, dataset: str) -> Optional[int]:
        if self._ring is None or not len(self._ring):
            return None
        node = self._ring.place(dataset)
        return self._ring.nodes.index(node)

    def execute(self, stmt: "Statement | str") -> QueryResult:
        self._check_live()
        q = stmt.compile() if isinstance(stmt, Statement) else str(stmt)
        kind = stmt.kind if isinstance(stmt, Statement) else "raw"
        t0 = time.perf_counter()
        raw = route_query(self._clis, q, place=self._place_hint)
        if hasattr(stmt, "finalize"):
            raw = stmt.finalize(raw)
        elapsed = time.perf_counter() - t0
        if isinstance(raw, np.ndarray):
            dtype, shape = str(raw.dtype), tuple(raw.shape)
            self.stats.result_bytes += raw.nbytes
        else:
            dtype = shape = None
        self.stats.n_queries += 1
        self.stats.query_s += elapsed
        self.stats.by_kind[kind] = self.stats.by_kind.get(kind, 0) + 1
        return QueryResult(query=q, kind=kind, value=raw, dtype=dtype,
                           shape=shape, elapsed_s=elapsed, attempts=1)

    def execute_all(self, stmts) -> list[QueryResult]:
        return [self.execute(s) for s in stmts]

    # -- live subscription ---------------------------------------------
    def watch(self, tar: str = "", *, timeout: Optional[float] = None,
              max_events: Optional[int] = None) -> MultiSubscription:
        self._check_live()
        return MultiSubscription(self.addrs, tar, timeout=timeout,
                                 max_events=max_events)

    # -- introspection --------------------------------------------------
    def server_stats(self) -> dict:
        """Summed engine counters across backends (+ ``backends``)."""
        self._check_live()
        out: dict = {"backends": len(self._clis)}
        for cli in self._clis:
            for k, v in cli.stats().items():
                if k != "ok" and isinstance(v, (int, float)):
                    out[k] = out.get(k, 0) + v
        return out

    def _check_live(self) -> None:
        if not self._opened:
            raise RuntimeError("RouterSession not opened "
                               "(use `with` or .open())")
        if self._closed:
            raise RuntimeError("RouterSession already closed")
