"""AnalysisSession — the one user-facing way to read from the analytical
side (mirror of :class:`repro_torch.transport.TransferSession` for egress).

    from repro_torch.analysis import AnalysisSession, tar

    with AnalysisSession(savime.addr) as an:
        res = an.execute(tar("velocity").attr("v").range(lo, hi).mean())
        print(res.value, res.elapsed_s)
        with an.watch("velocity") as sub:      # live subscription (§6:
            for event in sub:                  # query while running)
                ...

The session owns the SAVIME connection (or rides any ``run_savime``-
bearing transport via ``via=`` — the compute-node mode where the
analytical network is only reachable through staging), executes typed
statements from :mod:`repro_torch.analysis.query`, returns
:class:`QueryResult` (value + dtype/shape + timing), retries and
reconnects on connection loss, and keeps per-kind query stats.
"""
from __future__ import annotations

import dataclasses
import select as _select
import time
from typing import Any, Iterator, Optional

import numpy as np

from repro_torch.core import wire
from repro_torch.core.retry import RetryPolicy
from repro_torch.core.savime import SavimeClient, SavimeError
from repro_torch.analysis.query import Statement


class SubscriptionClosed(ConnectionError):
    """The subscription's push connection is gone (server died or the
    subscription was closed) — distinct from ``poll()`` returning ``None``,
    which only means nothing arrived within the timeout."""


# ---------------------------------------------------------------------------
# typed results / stats / events
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """One executed statement: the compiled text, the typed value, and
    where the time went."""

    query: str
    kind: str
    value: Any
    dtype: Optional[str]
    shape: Optional[tuple[int, ...]]
    elapsed_s: float
    attempts: int = 1

    @property
    def array(self) -> np.ndarray:
        """The value as a numpy array (scalars become 0-d)."""
        return np.asarray(self.value)

    @property
    def scalar(self) -> float:
        return float(self.array)


@dataclasses.dataclass
class AnalysisStats:
    """Per-session query accounting (reader-side twin of TransferStats)."""

    endpoint: str = ""
    n_queries: int = 0
    n_retries: int = 0
    n_reconnects: int = 0
    query_s: float = 0.0
    result_bytes: int = 0
    by_kind: dict = dataclasses.field(default_factory=dict)

    @property
    def mean_query_s(self) -> float:
        return self.query_s / max(self.n_queries, 1)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mean_query_s"] = self.mean_query_s
        return d

    @classmethod
    def merge(cls, stats) -> "AnalysisStats":
        """Combine per-session accounting into one reader-fleet view.

        Everything here is a flow (counts, summed query seconds, result
        bytes) so every field adds — unlike
        :meth:`TransferStats.merge`, no field is a high-water mark.
        ``by_kind`` histograms add key-wise; endpoints join with ``+``.
        """
        stats = list(stats)
        if not stats:
            return cls(endpoint="merged")
        endpoints = [s.endpoint for s in stats if s.endpoint]
        out = cls(endpoint="+".join(dict.fromkeys(endpoints)) or "merged")
        for s in stats:
            out.n_queries += s.n_queries
            out.n_retries += s.n_retries
            out.n_reconnects += s.n_reconnects
            out.query_s += s.query_s
            out.result_bytes += s.result_bytes
            for k, v in s.by_kind.items():
                out.by_kind[k] = out.by_kind.get(k, 0) + v
        return out


@dataclasses.dataclass(frozen=True)
class SubtarEvent:
    """One ``notify`` push: a subtar landed in ``tar`` while we watched."""

    tar: str
    origin: tuple[int, ...]
    shape: tuple[int, ...]
    attr: str
    seq: int

    @property
    def hi(self) -> tuple[int, ...]:
        """Inclusive upper corner — feeds straight into ``.range()``."""
        return tuple(o + s - 1 for o, s in zip(self.origin, self.shape))


# ---------------------------------------------------------------------------
# live subscription
# ---------------------------------------------------------------------------


class Subscription:
    """Iterator over subtar-arrival events for one TAR (``""`` = all,
    trailing ``*`` = prefix match).

    Registration is eager: by the time the constructor returns, the
    server acknowledged the subscription, so every subtar loaded after
    that point is delivered — no subscribe/ingest race. Iteration ends
    after ``max_events`` events or a ``timeout``-second wait with nothing
    arriving; ``poll`` never ends the iteration and is the right call in
    a supervision loop that owns its own stop condition.
    """

    def __init__(self, addr: str, tar: str = "", *,
                 timeout: Optional[float] = None,
                 max_events: Optional[int] = None):
        self.tar = tar
        self.timeout = timeout
        self.max_events = max_events
        self.n_events = 0
        self._closed = False
        self._sock = wire.connect(addr)
        header, _ = wire.request(self._sock, {"op": "subscribe", "tar": tar})
        if not header.get("ok"):
            self._sock.close()
            raise SavimeError(header.get("error", "subscribe failed"))
        self.start_seq = int(header.get("seq", 0))

    @property
    def closed(self) -> bool:
        """True once the push connection is gone (server side or ours)."""
        return self._closed

    def poll(self, timeout: Optional[float] = None) -> Optional[SubtarEvent]:
        """Next event, or ``None`` after ``timeout`` seconds of nothing
        arriving. A dead server is not a timeout: it raises
        :class:`SubscriptionClosed` (and sets :attr:`closed`), so a
        supervision loop can tell "quiet" from "gone"."""
        if self._closed:
            raise SubscriptionClosed(
                f"subscription to {self.tar!r} is closed")
        ready, _, _ = _select.select([self._sock], [], [], timeout)
        if not ready:
            return None
        try:
            header, _ = wire.recv_frame(self._sock)
        except (ConnectionError, OSError) as e:
            self.close()
            raise SubscriptionClosed(
                f"subscription to {self.tar!r}: server gone ({e})") from e
        if header.get("op") != "notify":
            return None
        self.n_events += 1
        return SubtarEvent(tar=header["tar"],
                           origin=tuple(header["origin"]),
                           shape=tuple(header["shape"]),
                           attr=header.get("attr", ""),
                           seq=int(header.get("seq", 0)))

    def __iter__(self) -> Iterator[SubtarEvent]:
        return self

    def __next__(self) -> SubtarEvent:
        if self.max_events is not None and self.n_events >= self.max_events:
            raise StopIteration
        try:
            ev = self.poll(self.timeout)
        except SubscriptionClosed:
            raise StopIteration from None
        if ev is None:
            raise StopIteration
        return ev

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# session
# ---------------------------------------------------------------------------


class AnalysisSession:
    """Context manager owning one analytical connection.

    Exactly one of:
      * ``addr``  — connect straight to a SAVIME server (analytical
        network; enables ``watch``);
      * ``via``   — ride anything with ``run_savime`` (a
        :class:`~repro_torch.transport.TransferSession` or Transport): the
        compute-node mode, where SAVIME is only reachable through the
        staging proxy. ``via`` objects own their connection, so retry /
        reconnect stays on the direct path only.
    """

    def __init__(self, addr: Optional[str] = None, *,
                 via: Optional[Any] = None, retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 deadline_s: Optional[float] = None,
                 label: Optional[str] = None):
        if (addr is None) == (via is None):
            raise ValueError(
                "AnalysisSession needs exactly one of addr= or via=")
        self.addr = addr
        self._via = via
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        # shared retry engine (DESIGN.md §15): exponential backoff with
        # full jitter, capped by an optional wall-clock deadline; exhausting
        # it raises the typed RetryExhausted instead of the last bare error
        self._retry = RetryPolicy(retries=retries, base_s=retry_backoff_s,
                                  deadline_s=deadline_s)
        self.stats = AnalysisStats(
            endpoint=label or addr or f"via:{type(via).__name__}")
        self._cli: Optional[SavimeClient] = None
        self._opened = False
        self._closed = False

    # -- lifecycle ------------------------------------------------------
    def open(self) -> "AnalysisSession":
        if self._opened:
            return self
        if self.addr is not None:
            self._cli = SavimeClient(self.addr)
        self._opened = True
        return self

    def __enter__(self) -> "AnalysisSession":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._closed = True
        if self._cli is not None:
            self._cli.close()
            self._cli = None

    # -- execution ------------------------------------------------------
    def execute(self, stmt: "Statement | str") -> QueryResult:
        """Run one typed statement (raw strings are accepted for
        debugging but deprecated — see DESIGN.md §8)."""
        self._check_live()
        q = stmt.compile() if isinstance(stmt, Statement) else str(stmt)
        kind = stmt.kind if isinstance(stmt, Statement) else "raw"
        t0 = time.perf_counter()
        attempts = 0
        retryable = getattr(stmt, "idempotent", False)
        for attempt in self._retry.attempts(f"query {kind}"):
            attempts += 1
            try:
                raw = self._run(q)
                break
            except (ConnectionError, OSError) as e:
                # SavimeError (semantic) propagates immediately; only a
                # lost connection on the session-owned path is retried,
                # and only for idempotent statements — the server may
                # have applied a create/load whose reply was lost
                if self._cli is None or not retryable:
                    raise
                self.stats.n_retries += 1
                attempt.backoff(e)     # jittered sleep or RetryExhausted
                try:
                    self._reconnect()
                except (ConnectionError, OSError):
                    pass   # still down: next attempt backs off again,
                #            so exhaustion surfaces as RetryExhausted
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
                           shape=shape, elapsed_s=elapsed, attempts=attempts)

    def execute_all(self, stmts) -> list[QueryResult]:
        return [self.execute(s) for s in stmts]

    def _run(self, q: str):
        if self._cli is not None:
            return self._cli.run(q)
        return self._via.run_savime(q)

    def _reconnect(self) -> None:
        assert self.addr is not None
        try:
            self._cli.close()
        except (OSError, AttributeError):
            pass
        self._cli = SavimeClient(self.addr)
        self.stats.n_reconnects += 1

    # -- live subscription ---------------------------------------------
    def watch(self, tar: str = "", *, timeout: Optional[float] = None,
              max_events: Optional[int] = None) -> Subscription:
        """Subscribe to subtar arrivals in ``tar`` (the paper's
        query-while-running goal made first-class). Needs a direct SAVIME
        address — the subscription is its own push connection, so queries
        on this session proceed while events stream in."""
        self._check_live()
        if self.addr is None:
            raise RuntimeError(
                "watch() needs a direct SAVIME address; via= sessions sit "
                "behind the staging control proxy, which has no push path")
        return Subscription(self.addr, tar, timeout=timeout,
                            max_events=max_events)

    # -- introspection --------------------------------------------------
    def server_stats(self) -> dict:
        self._check_live()
        if self._cli is not None:
            return self._cli.stats()
        return self._via.server_stats()

    def _check_live(self) -> None:
        if not self._opened:
            raise RuntimeError("AnalysisSession not opened "
                               "(use `with` or .open())")
        if self._closed:
            raise RuntimeError("AnalysisSession already closed")
