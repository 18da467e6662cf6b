"""FaultScheduler — the process-death half of the fault harness.

Runs the plan's ``kill`` rules on a wall-clock schedule relative to
:meth:`FaultScheduler.start`: at ``at_s`` seconds, invoke the registered
kill hook for the rule's ``target`` (``staging:0``, ``savime:1``,
``gateway`` — whatever the caller registered).  ``StagingPool.with_faults``
wires the pool's backends in automatically.

The scheduler owns one daemon thread, joined in :meth:`stop` — callers
must pair ``start``/``stop`` (the ``with_faults`` context manager does).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict

from repro_torch.faults.plan import FaultPlan


class FaultScheduler:
    """Scripted kills: sleeps to each rule's ``at_s``, fires its hook."""

    def __init__(self, plan: FaultPlan,
                 targets: Dict[str, Callable[[], None]]):
        self._rules = sorted(plan.kill_rules, key=lambda r: r.at_s)
        self._targets = dict(targets)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.killed: list[str] = []

    def start(self) -> "FaultScheduler":
        if self._rules and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="fault-sched", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        t0 = time.monotonic()
        for rule in self._rules:
            wait = rule.at_s - (time.monotonic() - t0)
            if wait > 0 and self._stop.wait(wait):
                return
            if self._stop.is_set():
                return
            hook = self._targets.get(rule.target)
            if hook is None:
                continue
            try:
                hook()
            except (OSError, RuntimeError):
                pass        # the target died on its own first — that's fine
            self.killed.append(rule.target)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
