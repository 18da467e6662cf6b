"""FCFS task queues + I/O thread pools with straggler mitigation.

The paper (§3.1): "Received datasets are queued and a pool of threads sends
them in a FCFS fashion. Similarly, the client has a queue of datasets and a
pool of I/O threads sending them to staging."

Beyond the paper (large-scale runnability): speculative re-execution of
stragglers — a watchdog re-enqueues tasks that exceed `straggler_timeout`
(transfer tasks are idempotent: same bytes / same dataset name), first
completion wins; plus bounded retries on failure (fault tolerance for
transient link errors).
"""
from __future__ import annotations

import collections
import threading
import time
import queue as _queue
from typing import Any, Callable, Optional


class TaskHandle:
    _GUARDED_BY = {"_callbacks": "_lock"}

    def __init__(self, fn: Callable, args: tuple, name: str):
        self.fn = fn
        self.args = args
        self.name = name
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.attempts = 0
        self.speculative = 0
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._lock = threading.Lock()
        self._callbacks: list[Callable[["TaskHandle"], None]] = []

    def complete(self, result=None, error=None) -> bool:
        """First completion wins (duplicate speculative runs are ignored)."""
        with self._lock:
            if self.done.is_set():
                return False
            self.result, self.error = result, error
            self.finished_at = time.perf_counter()
            self.done.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — callbacks must not kill workers
                pass
        return True

    def add_done_callback(self, fn: Callable[["TaskHandle"], None]) -> None:
        """Run ``fn(handle)`` once on completion (immediately if done)."""
        with self._lock:
            if not self.done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def wait(self, timeout: Optional[float] = None):
        if not self.done.wait(timeout):
            raise TimeoutError(f"task {self.name} not done")
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at and self.started_at:
            return self.finished_at - self.started_at
        return None


class FCFSPool:
    """Fixed pool of worker threads consuming a FIFO queue."""

    # aggregate counters share _pending_lock because _worker updates them
    # in the same critical section that decrements _pending
    _GUARDED_BY = {
        "_inflight": "_inflight_lock",
        "_pending": "_pending_lock",
        "n_completed": "_pending_lock",
        "n_failed": "_pending_lock",
        "_lat_sum": "_pending_lock",
        "_lat_count": "_pending_lock",
    }

    def __init__(self, n_threads: int, name: str = "pool",
                 straggler_timeout: Optional[float] = None,
                 max_retries: int = 2, completed_cap: int = 512):
        self.name = name
        self.straggler_timeout = straggler_timeout
        self.max_retries = max_retries
        self._q: _queue.Queue = _queue.Queue()
        self._inflight: dict[int, TaskHandle] = {}
        self._inflight_lock = threading.Lock()
        self._pending = 0
        self._pending_lock = threading.Condition()
        self._stop = threading.Event()
        self._stop_callbacks: list[Callable[[], None]] = []
        # bounded history: long-running servers complete millions of tasks —
        # keep aggregate latency stats plus a capped ring of recent handles
        # (each handle pins its fn/args, so an unbounded list leaks memory)
        self.completed: collections.deque = collections.deque(
            maxlen=completed_cap)
        self.n_completed = 0
        self.n_failed = 0
        self._lat_sum = 0.0
        self._lat_count = 0
        self._threads = [
            threading.Thread(target=self._worker, name=f"{name}-{i}",
                             daemon=True)
            for i in range(n_threads)
        ]
        for t in self._threads:
            t.start()
        self._watchdog = None
        if straggler_timeout:
            self._watchdog = threading.Thread(
                target=self._watch, name=f"{name}-watchdog", daemon=True)
            self._watchdog.start()

    # -- submission ---------------------------------------------------------
    def submit(self, fn: Callable, *args, name: str = "task") -> TaskHandle:
        h = TaskHandle(fn, args, name)
        with self._pending_lock:
            self._pending += 1
        self._q.put(h)
        return h

    def pending(self) -> int:
        """Tasks submitted but not yet completed (queued + in flight)."""
        with self._pending_lock:
            return self._pending

    def sync(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted task completed (paper's st.sync())."""
        deadline = time.monotonic() + timeout if timeout else None
        with self._pending_lock:
            while self._pending > 0:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(f"{self.name}.sync timed out")
                self._pending_lock.wait(remaining)

    def add_stop_callback(self, fn: Callable[[], None]) -> None:
        """Resource cleanup to run when the pool stops (e.g. closing the
        thread-local sockets its workers opened)."""
        self._stop_callbacks.append(fn)

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting work, let in-flight tasks finish, then run the
        cleanup callbacks.  Joining before cleanup matters: callbacks close
        the workers' thread-local sockets, which must not happen while a
        worker is mid-transfer (a task that was going to succeed would
        fail).  ``timeout`` bounds the total join wait (socket timeouts
        bound each task anyway); queued-but-unstarted tasks are abandoned,
        as before."""
        self._stop.set()
        for _ in self._threads:
            self._q.put(None)
        deadline = time.monotonic() + timeout if timeout else None
        for t in self._threads:
            if t is threading.current_thread() or not t.is_alive():
                continue
            remaining = None if deadline is None else \
                max(deadline - time.monotonic(), 0.0)
            t.join(remaining)
        if self._watchdog is not None \
                and self._watchdog is not threading.current_thread():
            # _stop is set, so the watchdog's wait() returns within
            # straggler_timeout/4 — bound the join the same way anyway
            remaining = None if deadline is None else \
                max(deadline - time.monotonic(), 0.0)
            self._watchdog.join(remaining)
        for fn in self._stop_callbacks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass

    # -- internals -----------------------------------------------------------
    def _worker(self) -> None:
        while not self._stop.is_set():
            h = self._q.get()
            if h is None:
                return
            if h.done.is_set():             # speculative duplicate already won
                self._q.task_done()
                continue
            h.started_at = h.started_at or time.perf_counter()
            h.attempts += 1
            tid = id(h)
            with self._inflight_lock:
                self._inflight[tid] = h
            try:
                res = h.fn(*h.args)
                first = h.complete(result=res)
            except BaseException as e:  # noqa: BLE001 — retried below
                # no retry once stop() was called: the re-enqueued task
                # would sit behind the shutdown sentinels forever, leaving
                # _pending stuck and hanging every later sync()
                if h.attempts <= self.max_retries and not h.done.is_set() \
                        and not self._stop.is_set():
                    self._q.put(h)          # bounded retry
                    first = False
                else:
                    first = h.complete(error=e)
            finally:
                with self._inflight_lock:
                    self._inflight.pop(tid, None)
                self._q.task_done()
            if first:
                self.completed.append(h)
                with self._pending_lock:
                    self.n_completed += 1
                    if h.error is not None:
                        self.n_failed += 1
                    lat = h.latency
                    if lat is not None:
                        self._lat_sum += lat
                        self._lat_count += 1
                    self._pending -= 1
                    self._pending_lock.notify_all()

    def _watch(self) -> None:
        assert self.straggler_timeout
        while not self._stop.wait(self.straggler_timeout / 4):
            now = time.perf_counter()
            with self._inflight_lock:
                slow = [h for h in self._inflight.values()
                        if h.started_at and not h.done.is_set()
                        and now - h.started_at > self.straggler_timeout
                        and h.speculative == 0]
            for h in slow:                  # speculative re-execution
                h.speculative += 1
                self._q.put(h)

    # -- stats ----------------------------------------------------------------
    def latencies(self) -> list[float]:
        """Latencies of the most recent completions (capped ring)."""
        return [h.latency for h in list(self.completed)
                if h.latency is not None]

    def latency_stats(self) -> dict:
        """Aggregate latency counters over *all* completions (unbounded
        count, bounded memory — the ring only keeps recent handles)."""
        with self._pending_lock:
            return {"count": self._lat_count,
                    "total_s": self._lat_sum,
                    "mean_s": self._lat_sum / self._lat_count
                    if self._lat_count else 0.0,
                    "failed": self.n_failed}
