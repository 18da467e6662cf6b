"""StagingPool — N (SAVIME, staging) pairs behind one GatewayServer.

The deployment unit for multi-tenant in-transit analysis: each backend
is a full vertical slice (its own SAVIME engine fed by its own staging
server), and the gateway is the single address producers and analysts
talk to. Placement is per dataset, so one logical TAR's subtars spread
across the pool and the gateway's scatter-gather router
(:mod:`repro_torch.gateway.router`) reassembles query answers.

Used by the launchers (``--pool N``), the gateway tests, and
``benchmarks/fig11_gateway.py``; owns startup/shutdown ordering
(backends up before the gateway accepts, gateway down before backends).
"""
from __future__ import annotations

import contextlib
from typing import Iterable, Optional, Sequence

from repro_torch.core.savime import SavimeServer
from repro_torch.core.staging import StagingServer
from repro_torch.gateway.ring import RingNode
from repro_torch.gateway.server import GatewayServer
from repro_torch.gateway.tenancy import Tenant


class StagingPool:
    """Start/stop harness for a gateway-fronted staging fleet."""

    def __init__(self, n_backends: int = 2, *,
                 mem_capacity: int = 1 << 30,
                 weights: Optional[Sequence[float]] = None,
                 tenants: Iterable[Tenant] = (),
                 default_quota_bytes: Optional[int] = None,
                 require_auth: bool = False,
                 vnodes: int = 64,
                 health_interval: float = 0.25,
                 staging_kwargs: Optional[dict] = None):
        if n_backends < 1:
            raise ValueError("pool needs at least one backend")
        if weights is not None and len(weights) != n_backends:
            raise ValueError("weights must match n_backends")
        self.savimes: list[SavimeServer] = []
        self.stagings: list[StagingServer] = []
        self.gateway: Optional[GatewayServer] = None
        self._n = n_backends
        self._weights = weights
        self._mem_capacity = mem_capacity
        self._tenants = tuple(tenants)
        self._default_quota_bytes = default_quota_bytes
        self._require_auth = require_auth
        self._vnodes = vnodes
        self._health_interval = health_interval
        self._staging_kwargs = dict(staging_kwargs or {})

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "StagingPool":
        try:
            for i in range(self._n):
                sv = SavimeServer().start()
                st = StagingServer(sv.addr, mem_capacity=self._mem_capacity,
                                   **self._staging_kwargs).start()
                self.savimes.append(sv)
                self.stagings.append(st)
            nodes = [RingNode(name=f"backend{i}", addr=st.addr,
                              savime_addr=sv.addr,
                              weight=(self._weights[i]
                                      if self._weights else 1.0))
                     for i, (sv, st) in enumerate(zip(self.savimes,
                                                      self.stagings))]
            self.gateway = GatewayServer(
                nodes, tenants=self._tenants,
                default_quota_bytes=self._default_quota_bytes,
                require_auth=self._require_auth, vnodes=self._vnodes,
                health_interval=self._health_interval).start()
        except BaseException:
            self.stop()
            raise
        return self

    def stop(self) -> None:
        if self.gateway is not None:
            self.gateway.stop()
            self.gateway = None
        for st in self.stagings:
            st.stop()
        for sv in self.savimes:
            sv.stop()
        self.stagings.clear()
        self.savimes.clear()

    def __enter__(self) -> "StagingPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- convenience ----------------------------------------------------
    @property
    def addr(self) -> str:
        """The gateway address — the only address clients need."""
        if self.gateway is None:
            raise RuntimeError("pool is not running")
        return self.gateway.addr

    @property
    def savime_addrs(self) -> list[str]:
        return [sv.addr for sv in self.savimes]

    def backend_stats(self) -> dict:
        """In-process view of per-backend staging counters (the
        accounting-parity side the gateway's ``totals`` must match)."""
        return {f"backend{i}": dict(st.stats)
                for i, st in enumerate(self.stagings)}

    def kill_backend(self, i: int) -> None:
        """Hard-stop one staging server (its SAVIME stays up — already
        acked datasets must remain queryable); health probes will fail
        it out of the ring."""
        self.stagings[i].stop()

    # -- fault harness ---------------------------------------------------
    @contextlib.contextmanager
    def with_faults(self, plan):
        """Run a :class:`~repro_torch.faults.FaultPlan` against this pool.

            with pool.with_faults(FaultPlan.parse(spec)) as harness:
                ... drive traffic; harness.injector.fired /
                    harness.scheduler.killed tell what happened ...

        Wire rules apply only to client connections targeting the pool
        (gateway + backend staging addrs); kill rules resolve
        ``staging:i`` / ``savime:i`` / ``gateway`` targets to this
        pool's processes. Install/uninstall is scoped to the block.
        """
        from repro_torch.faults.inject import injected
        from repro_torch.faults.sched import FaultScheduler
        if self.gateway is None:
            raise RuntimeError("pool is not running")
        scope = [self.addr] + [st.addr for st in self.stagings] \
            + [sv.addr for sv in self.savimes]
        targets = {"gateway": self.gateway.stop}
        for i, st in enumerate(self.stagings):
            targets[f"staging:{i}"] = st.stop
        for i, sv in enumerate(self.savimes):
            targets[f"savime:{i}"] = sv.stop
        with injected(plan, scope=scope) as inj:
            sched = FaultScheduler(plan, targets).start()
            harness = _FaultHarness(inj, sched)
            try:
                yield harness
            finally:
                sched.stop()


class _FaultHarness:
    """What ``with_faults`` yields: both halves of the running harness."""

    def __init__(self, injector, scheduler):
        self.injector = injector
        self.scheduler = scheduler
