"""TransferSession — the one user-facing way to move data to analysis.

    from repro_torch.transport import TransferSession, TransportConfig

    cfg = TransportConfig(staging_addr=staging.addr, io_threads=2)
    with TransferSession("rdma_staged", cfg) as sess:
        fut = sess.write("D", array)        # non-blocking, returns a future
        sess.sync()                         # all writes reached staging
        sess.drain()                        # queryable at the endpoint
    print(sess.stats.staging_gbps)

On top of any registered :class:`~repro_torch.transport.base.Transport` the
session owns:

  * buffer pinning — a written buffer is referenced until its transfer
    completes (the paper's "must not be mutated until sync()" contract);
  * backpressure — ``cfg.max_inflight_bytes`` bounds pinned bytes;
    ``write`` blocks when the bound would be exceeded (a producer can
    never run arbitrarily far ahead of the network);
  * futures — every ``write`` returns a :class:`DatasetFuture`;
  * metrics — :class:`~repro_torch.transport.base.TransferStats` with per-phase
    timings, plus optional ``on_event`` hooks for live instrumentation.
"""
from __future__ import annotations

import queue
import secrets
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.tensors import dtype_name
from repro_torch.transport.base import (Transport, TransportConfig, TransferStats,
                                  create)


class DatasetFuture:
    """Completion future for one written dataset."""

    def __init__(self, name: str, nbytes: int, handle):
        self.name = name
        self.nbytes = nbytes
        self._handle = handle

    def wait(self, timeout: Optional[float] = None):
        """Block until this dataset reached staging; raises on failure."""
        return self._handle.wait(timeout)

    def done(self) -> bool:
        return self._handle.done.is_set()

    def add_done_callback(self, fn: Callable) -> None:
        self._handle.add_done_callback(lambda _h: fn(self))


class _ReplayHandle:
    """TaskHandle-shaped facade whose completion survives replays.

    The journal swaps the *inner* transport handle on every replay; this
    outer handle is what the :class:`DatasetFuture` holds, and it
    completes exactly once — with the first definitive outcome."""

    def __init__(self, name: str):
        self.name = name
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._callbacks: list = []

    def complete(self, result=None, error=None) -> None:
        with self._lock:
            if self.done.is_set():
                return
            self.result, self.error = result, error
            callbacks, self._callbacks = self._callbacks, []
            self.done.set()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — callbacks must not break acks
                pass

    def wait(self, timeout: Optional[float] = None):
        if not self.done.wait(timeout):
            raise TimeoutError(f"transfer {self.name!r} still in flight")
        if self.error is not None:
            raise self.error
        return self.result

    def add_done_callback(self, fn: Callable) -> None:
        with self._lock:
            if not self.done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)


class _Journaled:
    """One in-flight journal entry: everything needed to replay a write."""

    __slots__ = ("name", "dtype", "arr", "epoch", "outer", "deadline",
                 "attempts")

    def __init__(self, name, dtype, arr, epoch, outer, deadline):
        self.name = name
        self.dtype = dtype
        self.arr = arr              # the pinned buffer (not a copy): the
        #                             replay source
        self.epoch = epoch
        self.outer = outer
        self.deadline = deadline
        self.attempts = 0


class TransferSession:
    """Context manager owning one transport lifecycle.

    May also be used non-contextually: ``sess = TransferSession(...).open()``
    then ``sess.close()``. On clean context exit the session syncs and
    drains before closing (durability by default); on exception it closes
    immediately.
    """

    def __init__(self, transport: "str | Transport",
                 cfg: Optional[TransportConfig] = None, *,
                 label: Optional[str] = None,
                 on_event: Optional[Callable[[dict], None]] = None):
        if isinstance(transport, Transport):
            self.transport = transport
        else:
            self.transport = create(transport, cfg or TransportConfig())
        self.cfg = self.transport.cfg
        self.stats = TransferStats(engine=label or self.transport.name)
        self.hooks: list[Callable[[dict], None]] = [on_event] if on_event else []
        self._opened = False
        self._closed = False
        self._t0: Optional[float] = None          # first-write clock
        self._unsynced = False                    # writes since last sync?
        self._undrained = False                   # writes since last drain?
        self._cond = threading.Condition()
        self._inflight = 0                        # pinned, not yet completed
        self._pinned: dict[int, object] = {}      # future id -> buffer ref
        # in-flight journal (DESIGN.md §15): every submitted dataset keeps
        # its pinned buffer under a monotonic (name, epoch) identity until
        # acked; a retryable failure re-submits it through the replay
        # worker and the receiver dedups on the epoch. Active only when
        # the engine can thread the epoch through (supports_replay).
        self._journal_on = bool(self.cfg.journal and
                                self.transport.supports_replay)
        self._journal: dict[str, _Journaled] = {}     # epoch -> entry
        self._epoch_tag = secrets.token_hex(4)
        self._epoch_seq = 0
        self._max_replays = max(1, self.cfg.retry)
        self._replay_q: queue.Queue = queue.Queue()
        self._replay_worker: Optional[threading.Thread] = None
        self._close_evt = threading.Event()

    # -- lifecycle ------------------------------------------------------
    def open(self) -> "TransferSession":
        if self._opened:
            return self
        t = time.perf_counter()
        self.transport.open()
        self.stats.open_s = time.perf_counter() - t
        self._opened = True
        if self._journal_on:
            self._replay_worker = threading.Thread(
                target=self._replay_loop, name="session-replay", daemon=True)
            self._replay_worker.start()
        self._emit("open")
        return self

    def __enter__(self) -> "TransferSession":
        return self.open()

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.sync()
            self.drain()
        self.close()

    def close(self) -> None:
        if self._closed or not self._opened:
            self._closed = True
            return
        self._close_evt.set()
        if self._replay_worker is not None:
            self._replay_q.put(None)              # shutdown sentinel
            self._replay_worker.join(5.0)
            self._replay_worker = None
        self._collect_durability_stats()
        self._collect_channel_stats()
        self._collect_page_stats()
        self._collect_gateway_stats()
        self._collect_codec_stats()
        t = time.perf_counter()
        try:
            self.transport.close()
        finally:
            self._closed = True
            self.stats.close_s = time.perf_counter() - t
            if self._t0 is not None and self.stats.end_to_end_s == 0.0:
                self.stats.end_to_end_s = t - self._t0
            self._emit("close")

    # -- data plane -----------------------------------------------------
    def write(self, name: str, buf, dtype: Optional[str] = None,
              nbytes: Optional[int] = None) -> DatasetFuture:
        """Non-blocking enqueue of one named buffer.

        Blocks only when ``cfg.max_inflight_bytes`` would be exceeded
        (backpressure); a single buffer larger than the bound is admitted
        alone rather than deadlocking.

        ``buf`` may be a torch tensor on any device: it is pinned as it is
        and handed to the transport, whose sender encodes it where it lies
        or copies it to the host (``nbytes`` applies to host buffers only).

        Every buffer, host or tensor, is held as it is, not copied, until
        the write is acknowledged, and the journal replays it from there:
        a replay after a lost connection sends what the buffer holds at
        that time. So the caller must not mutate it until ``sync()``
        returns (the paper's rule, and the reference's for numpy input).
        """
        self._check_live()
        if isinstance(buf, torch.Tensor):
            if nbytes is not None:
                raise ValueError("nbytes applies to host buffers, not tensors")
            arr = buf.detach().contiguous()
            dtype = dtype or dtype_name(arr)
            size = arr.numel() * arr.element_size()
        else:
            arr = buf if isinstance(buf, np.ndarray) else \
                np.frombuffer(buf, dtype=np.uint8)
            if nbytes is not None:
                arr = arr.reshape(-1).view(np.uint8)[:nbytes]
            dtype = dtype or str(arr.dtype)
            size = arr.nbytes
        limit = self.cfg.max_inflight_bytes
        t_wait = time.perf_counter()
        with self._cond:
            while limit and self._inflight > 0 and \
                    self._inflight + size > limit:
                self._cond.wait(0.5)
            self._inflight += size
            self.stats.peak_inflight_bytes = max(
                self.stats.peak_inflight_bytes, self._inflight)
        self.stats.write_wait_s += time.perf_counter() - t_wait
        if self._t0 is None:
            self._t0 = time.perf_counter()
        epoch = None
        if self._journal_on:
            with self._cond:
                self._epoch_seq += 1
                epoch = f"{self._epoch_tag}-{self._epoch_seq}"
        try:
            if epoch is not None:
                entry = _Journaled(
                    name, dtype, arr, epoch, _ReplayHandle(name),
                    deadline=(time.monotonic() + self.cfg.deadline_s
                              if self.cfg.deadline_s else None))
                with self._cond:
                    self._journal[epoch] = entry
                inner = self.transport.write_epoch(name, dtype, arr, epoch)
                inner.add_done_callback(self._journal_chain(entry))
                handle = entry.outer
            else:
                handle = self.transport.write(name, dtype, arr)
        except BaseException:
            # striped transports can fail synchronously (stripe_open is a
            # control RTT); the reserved inflight bytes must be returned
            # or later writes block against a phantom reservation
            with self._cond:
                if epoch is not None:
                    self._journal.pop(epoch, None)
                self._inflight -= size
                self._cond.notify_all()
            raise
        fut = DatasetFuture(name, size, handle)
        with self._cond:
            self._pinned[id(fut)] = arr           # pin until completion
        handle.add_done_callback(lambda _h: self._release(fut))
        self._unsynced = self._undrained = True
        self.stats.nbytes += size
        self.stats.n_datasets += 1
        self._emit("write", name=name, nbytes=size)
        return fut

    def write_all(self, names: Sequence[str], buffers: Sequence) \
            -> list[DatasetFuture]:
        return [self.write(n, b) for n, b in zip(names, buffers)]

    def _release(self, fut: DatasetFuture) -> None:
        with self._cond:
            if self._pinned.pop(id(fut), None) is not None:
                self._inflight -= fut.nbytes
            self._cond.notify_all()

    # -- in-flight journal (DESIGN.md §15) -------------------------------
    def _journal_chain(self, entry: _Journaled) -> Callable:
        """Done-callback for one inner transport handle: settle the entry
        (ack, replay, or give up) when the attempt finishes."""
        return lambda h: self._settle(entry, getattr(h, "error", None),
                                      getattr(h, "result", None))

    def _settle(self, entry: _Journaled, err, result=None) -> None:
        if err is None:
            with self._cond:
                self._journal.pop(entry.epoch, None)
                self._cond.notify_all()
            entry.outer.complete(result=result)
            return
        retryable = isinstance(err, (ConnectionError, TimeoutError, OSError))
        expired = entry.deadline is not None and \
            time.monotonic() > entry.deadline
        if retryable and not expired and \
                entry.attempts < self._max_replays and \
                not self._close_evt.is_set():
            self._replay_q.put(entry.epoch)
            return
        with self._cond:
            self._journal.pop(entry.epoch, None)
            self._cond.notify_all()
        entry.outer.complete(error=err)

    def _replay_loop(self) -> None:
        """Single worker re-submitting failed journal entries with
        exponential backoff. The receiver dedups on (name, epoch), so a
        replay of a write whose ack was merely lost is a no-op there."""
        while True:
            epoch = self._replay_q.get()
            if epoch is None:
                return
            with self._cond:
                entry = self._journal.get(epoch)
            if entry is None:
                continue                 # settled while queued
            entry.attempts += 1
            self.stats.replays += 1
            delay = min(2.0, 0.05 * (1 << min(entry.attempts, 6)))
            if self._close_evt.wait(delay):
                return
            self._emit("replay", name=entry.name, epoch=epoch,
                       attempt=entry.attempts)
            try:
                inner = self.transport.write_epoch(
                    entry.name, entry.dtype, entry.arr, epoch, replay=True)
            except Exception as e:  # noqa: BLE001 — settle decides
                self._settle(entry, e)
                continue
            inner.add_done_callback(self._journal_chain(entry))

    def _collect_durability_stats(self) -> None:
        """Pull the receiver's replay-dedup counter into the stats (how
        many replays it recognised as already-acked epochs)."""
        if not self._journal_on:
            return
        try:
            ss = self.transport.server_stats()
        except Exception:  # noqa: BLE001 — stats must not break close
            return
        if isinstance(ss, dict):
            self.stats.replay_dups = int(ss.get("replay_dups") or 0)

    # -- barriers -------------------------------------------------------
    def sync(self, timeout: Optional[float] = None) -> None:
        """Block until all written buffers reached staging — including
        journaled writes still being replayed after a reconnect."""
        self._check_live()
        deadline = time.monotonic() + timeout if timeout else None
        self.transport.sync(timeout)
        if self._journal_on:
            # a replaying write is out of the transport's queues (its
            # failed attempt completed there) but not yet durable — the
            # sync contract covers it too
            with self._cond:
                while self._journal:
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TimeoutError(
                                f"{len(self._journal)} journaled writes "
                                "still replaying")
                    self._cond.wait(min(remaining, 0.25)
                                    if remaining else 0.25)
        # only the sync that follows new writes defines the phase timing —
        # the redundant sync on clean __exit__ must not inflate it
        if self._t0 is not None and self._unsynced:
            self.stats.to_staging_s = time.perf_counter() - self._t0
        self._unsynced = False
        self._collect_channel_stats()
        self._collect_codec_stats()
        self._emit("sync")

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until staged data is queryable at the endpoint."""
        self._check_live()
        self.transport.drain(timeout)
        if self._t0 is not None and self._undrained:
            self.stats.end_to_end_s = time.perf_counter() - self._t0
        self._undrained = False
        self._emit("drain")

    # -- control plane --------------------------------------------------
    def run_savime(self, q):
        """Run one analytical operator over this transport's control path.
        ``q`` may be a typed statement from :mod:`repro_torch.analysis.query`
        (preferred) or raw mini-language text (deprecated as a user API —
        DESIGN.md §8)."""
        self._check_live()
        if hasattr(q, "compile"):
            q = q.compile()
        return self.transport.run_savime(q)

    def analysis(self, **kw) -> "object":
        """Open a typed :class:`~repro_torch.analysis.AnalysisSession` riding
        this session's control path (compute nodes reach SAVIME only
        through staging — paper §3.1)."""
        from repro_torch.analysis import AnalysisSession  # local: avoids cycle
        return AnalysisSession(via=self, **kw).open()

    def server_stats(self) -> dict:
        self._check_live()
        return self.transport.server_stats()

    # -- introspection --------------------------------------------------
    @property
    def inflight_bytes(self) -> int:
        with self._cond:
            return self._inflight

    def add_metrics_hook(self, fn: Callable[[dict], None]) -> None:
        self.hooks.append(fn)

    def _emit(self, event: str, **kw) -> None:
        if not self.hooks:
            return
        payload = {"event": event, "engine": self.stats.engine, **kw}
        for fn in self.hooks:
            try:
                fn(payload)
            except Exception:  # noqa: BLE001 — hooks must not break egress
                pass

    def _collect_channel_stats(self) -> None:
        """Snapshot per-channel byte/latency breakdowns into the stats
        (striped transports only; single-connection paths report [])."""
        try:
            ch = self.transport.channel_stats()
        except Exception:  # noqa: BLE001 — stats must not break egress
            return
        if ch:
            self.stats.channels = ch

    def _collect_page_stats(self) -> None:
        """Snapshot staging-side page/spill/dedup counters into the stats
        (paged staging only; flat paths report {})."""
        if self.cfg.page_bytes <= 0:
            return
        try:
            pg = self.transport.page_stats()
        except Exception:  # noqa: BLE001 — stats must not break egress
            return
        if pg:
            self.stats.pages = pg

    def _collect_gateway_stats(self) -> None:
        """Snapshot the gateway's fleet view (placement, tenancy,
        admission totals) into the stats (pool mode only; direct
        staging paths report {})."""
        if self.cfg.gateway_addr is None:
            return
        try:
            gw = self.transport.gateway_stats()
        except Exception:  # noqa: BLE001 — stats must not break egress
            return
        if gw:
            self.stats.gateway = gw

    def _collect_codec_stats(self) -> None:
        """Snapshot sender-side codec accounting (raw vs wire bytes,
        encode time) into the stats (``cfg.codec != "none"`` only)."""
        if self.cfg.codec == "none":
            return
        try:
            cs = self.transport.codec_stats()
        except Exception:  # noqa: BLE001 — stats must not break egress
            return
        if cs:
            self.stats.codec = cs

    def _check_live(self) -> None:
        if not self._opened:
            raise RuntimeError("TransferSession not opened "
                               "(use `with` or .open())")
        if self._closed:
            raise RuntimeError("TransferSession already closed")


def run_engine(engine: str, buffers: Sequence, names: Sequence[str],
               cfg: TransportConfig, *, label: Optional[str] = None,
               drain: bool = True) -> TransferStats:
    """One-shot convenience: ship ``buffers`` through ``engine``.

    This is what the old ``run_rdma_staged`` / ``run_scp`` /
    ``run_ssh_direct`` drivers collapse into.
    """
    with TransferSession(engine, cfg, label=label) as sess:
        for name, buf in zip(names, buffers):
            sess.write(name, buf)
        sess.sync()
        if drain:
            sess.drain()
    return sess.stats
