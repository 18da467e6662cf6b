"""Adaptive small-dataset coalescing for the egress path (DESIGN.md §10).

The paper's Fig 3 pathology: as datasets shrink, per-dataset protocol
costs (reservation round-trip, registration, framing, syscalls) stop
amortizing and throughput collapses. ADIOS2/DataSpaces-style staging
systems attack this by aggregating many small writes into fixed-format
jumbo messages; this module is that aggregation layer for every engine
that opts in via ``TransportConfig(coalesce_bytes=..., linger_ms=...)``.

    Coalescer(flush_fn, coalesce_bytes=1 << 20, linger_ms=2.0)

``add(name, dtype, buf)`` buffers one dataset below the threshold and
returns a :class:`~repro_torch.core.queues.TaskHandle` that completes when its
batch lands. A batch flushes when

  * **size** — buffered bytes reach ``coalesce_bytes`` (or ``max_items``
    datasets), the jumbo frame is full;
  * **linger** — ``linger_ms`` elapsed since the first buffered dataset,
    bounding the latency a small write can be held back;
  * **close / sync** — lifecycle barriers never leave datasets behind.

``flush_fn(items)`` performs the actual transfer (one vectored
``batch_open`` + ``batch_write`` round-trip on the staged path); the
coalescer completes or fails every handle in the batch and serializes
flushes on one worker thread, so ``flush_fn`` needs no locking of its
own. Datasets at or above the threshold must bypass the coalescer
entirely — callers keep their existing block/striped path, which is why
``coalesce_bytes=0`` (the default) is byte-identical legacy behavior.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from repro_torch.core.queues import TaskHandle

DEFAULT_LINGER_MS = 2.0
DEFAULT_MAX_ITEMS = 512


@dataclasses.dataclass
class CoalesceItem:
    """One buffered small dataset awaiting its batch."""

    name: str
    dtype: str
    buf: object            # flat uint8 view of the caller's buffer
    nbytes: int
    handle: TaskHandle
    extra: Optional[dict] = None   # codec header fields riding batch_open


class Coalescer:
    """Batches sub-threshold datasets into jumbo flushes."""

    # ``stats`` is only touched by the single worker thread; reads from
    # other threads are monitoring-only, so it stays unguarded.
    _GUARDED_BY = {
        "_pending": "_cond",
        "_pending_bytes": "_cond",
        "_deadline": "_cond",
        "_force": "_cond",
        "_inflight": "_cond",
        "_stop": "_cond",
    }

    def __init__(self, flush_fn: Callable[[list], None],
                 coalesce_bytes: int,
                 linger_ms: float = DEFAULT_LINGER_MS,
                 max_items: int = DEFAULT_MAX_ITEMS):
        if coalesce_bytes <= 0:
            raise ValueError("Coalescer needs coalesce_bytes > 0 "
                             "(0 disables coalescing at the caller)")
        self.coalesce_bytes = coalesce_bytes
        self.linger_s = max(linger_ms, 0.0) / 1e3
        self.max_items = max(1, max_items)
        self._flush_fn = flush_fn
        self._cond = threading.Condition()
        self._pending: list[CoalesceItem] = []
        self._pending_bytes = 0
        self._deadline: Optional[float] = None   # linger expiry of batch 0
        self._force = False
        self._inflight = 0                       # batches inside flush_fn
        self._stop = False
        self.stats = {"batches": 0, "datasets": 0, "bytes": 0, "failures": 0}
        self._worker = threading.Thread(target=self._run, name="coalescer",
                                        daemon=True)
        self._worker.start()

    # -- producer side --------------------------------------------------
    def add(self, name: str, dtype: str, buf, nbytes: int,
            extra: Optional[dict] = None) -> TaskHandle:
        """Buffer one small dataset; returns its completion handle."""
        handle = TaskHandle(self._flush_fn, (), name=f"coalesce-{name}")
        item = CoalesceItem(name, dtype, buf, nbytes, handle, extra)
        with self._cond:
            if self._stop:
                raise RuntimeError("Coalescer is closed")
            if not self._pending:
                self._deadline = time.monotonic() + self.linger_s
            self._pending.append(item)
            self._pending_bytes += nbytes
            self._cond.notify_all()
        return handle

    def flush(self) -> None:
        """Request an asynchronous flush of whatever is buffered now."""
        with self._cond:
            self._force = True
            self._cond.notify_all()

    def sync(self, timeout: Optional[float] = None) -> None:
        """Flush and block until every added dataset's batch completed
        (successfully or not — per-item failures live on the handles)."""
        deadline = time.monotonic() + timeout if timeout else None
        with self._cond:
            self._force = True
            self._cond.notify_all()
            while self._pending or self._inflight:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"coalescer sync: {len(self._pending)} buffered "
                            f"+ {self._inflight} in-flight batches")
                self._cond.wait(remaining)

    def close(self, timeout: float = 30.0) -> None:
        """Flush everything still buffered, then stop the worker."""
        with self._cond:
            self._stop = True
            self._force = True
            self._cond.notify_all()
        self._worker.join(timeout)
        # a worker that died anyway must not strand handles forever
        with self._cond:
            stranded, self._pending = self._pending, []
            self._pending_bytes = 0
        for it in stranded:
            it.handle.complete(error=RuntimeError("coalescer closed"))

    def pending(self) -> int:
        with self._cond:
            return len(self._pending)

    # -- worker ---------------------------------------------------------
    def _due(self) -> bool:  # holds: self._cond
        if not self._pending:
            return False
        return (self._force
                or self._pending_bytes >= self.coalesce_bytes
                or len(self._pending) >= self.max_items
                or (self._deadline is not None
                    and time.monotonic() >= self._deadline))

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._due():
                    if self._stop:
                        return
                    timeout = None
                    if self._pending and self._deadline is not None:
                        timeout = max(self._deadline - time.monotonic(),
                                      0.0) or 0.001
                    self._cond.wait(timeout)
                batch, self._pending = self._pending, []
                self._pending_bytes = 0
                self._deadline = None
                if not self._stop:
                    self._force = False
                self._inflight += 1
            try:
                self._flush_fn(batch)
            except BaseException as e:  # noqa: BLE001 — fail the batch
                self.stats["failures"] += 1
                for it in batch:
                    it.handle.complete(error=e)
            else:
                self.stats["batches"] += 1
                self.stats["datasets"] += len(batch)
                self.stats["bytes"] += sum(it.nbytes for it in batch)
                for it in batch:
                    it.handle.complete(result=it.nbytes)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()
