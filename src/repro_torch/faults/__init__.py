"""repro_torch.faults — deterministic, seeded fault injection (DESIGN.md §15).

Three pieces:

* :mod:`repro_torch.faults.plan`   — ``FaultPlan`` / ``FaultRule``: the seeded
  schedule DSL (also what the ``--faults`` launcher flag parses).
* :mod:`repro_torch.faults.inject` — ``FaultInjector``: the wire-level hook
  that drops / delays / duplicates / corrupts / partitions traffic on
  registered client connections.
* :mod:`repro_torch.faults.sched`  — ``FaultScheduler``: scripted process
  kills (staging / SAVIME / gateway) at plan-relative times.

Typical test usage::

    plan = FaultPlan.parse("seed=7;drop:op=stripe,nth=3")
    with injected(plan) as inj:
        ... run a transfer; the client retries/replays ...
    assert inj.fired["drop"] == 1
"""
from repro_torch.faults.plan import KINDS, FaultPlan, FaultRule
from repro_torch.faults.inject import FaultInjector, injected, install, uninstall
from repro_torch.faults.sched import FaultScheduler

__all__ = [
    "KINDS",
    "FaultPlan",
    "FaultRule",
    "FaultInjector",
    "FaultScheduler",
    "injected",
    "install",
    "uninstall",
]
