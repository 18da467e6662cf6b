"""FaultInjector — the wire-level half of the fault harness.

The injector installs as a module-level hook inside :mod:`repro_torch.core.wire`
(:func:`install` / :func:`uninstall`).  Only sockets *registered* with the
injector are in scope — ``wire.connect`` registers every socket it creates
while a hook is installed, optionally filtered by an address ``scope`` —
so server-side accepted sockets (and any connection opened before the
harness went up) pass through untouched.  That is the "injectable conn
factory": the faulty behaviour follows the client connections created
under the plan, deterministically.

Semantics per kind (see :mod:`repro_torch.faults.plan` for the schedule DSL):

* ``drop`` / ``partition`` close the socket and raise ``ConnectionError``
  from the send call.  A *silent* frame drop is deliberately not offered:
  the stripe protocol matches acks FIFO against in-flight frames, so a
  swallowed frame would desync the stream rather than exercise recovery —
  on a stream transport, "the frame was lost" means "the link broke".
* ``partition`` additionally fails every subsequent ``wire.connect`` to
  the matched peer for ``duration_s`` seconds (reconnect storms hit the
  wall the way a real network partition provides).
* ``corrupt`` flips bytes in a **copy** of the payload — the caller's
  pinned buffer (the journal's replay source) is never touched.
* ``delay`` sleeps before the frame leaves; ``dup`` sends it twice.

All mutable state lives behind one leaf lock; sleeps and socket closes
happen outside it.
"""
from __future__ import annotations

import random
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Optional, Sequence

from repro_torch.faults.plan import FaultPlan, FaultRule

# _GUARDED_BY (reprolint): all of FaultInjector._match_counts,
# FaultInjector._partitions, FaultInjector.fired: FaultInjector._lock

_GUARDED_BY = {
    "FaultInjector._match_counts": "FaultInjector._lock",
    "FaultInjector._partitions": "FaultInjector._lock",
    "FaultInjector.fired": "FaultInjector._lock",
}


def _sever(sock) -> None:
    try:
        sock.close()
    except OSError:
        pass


class FaultInjector:
    """Seeded, rule-driven traffic mangler for registered sockets."""

    def __init__(self, plan: FaultPlan,
                 scope: Optional[Sequence[str]] = None):
        self.plan = plan
        self._scope = tuple(scope) if scope else None
        self._rng = random.Random(plan.seed)
        self._lock = threading.Lock()
        self._match_counts: dict[int, int] = {}
        self._partitions: list[tuple[Optional[str], float]] = []
        self._socks: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.fired: dict[str, int] = {}

    # -- scope ----------------------------------------------------------
    def register(self, sock, addr: str) -> None:
        """Bring one connection into scope (called by ``wire.connect``)."""
        if self._scope is not None and \
                not any(s in addr for s in self._scope):
            return
        self._socks[sock] = addr

    def addr_of(self, sock) -> Optional[str]:
        return self._socks.get(sock)

    # -- manual controls (tests) ---------------------------------------
    def partition(self, peer: Optional[str], duration_s: float) -> None:
        """Start a partition by hand (tests that don't want a trigger
        frame)."""
        until = time.monotonic() + duration_s
        with self._lock:
            self._partitions.append((peer, until))
            self.fired["partition"] = self.fired.get("partition", 0) + 1

    def heal(self) -> None:
        """Lift every active partition immediately."""
        with self._lock:
            self._partitions.clear()

    # -- hook points (called from repro_torch.core.wire) ---------------------
    def check_connect(self, addr: str) -> None:
        now = time.monotonic()
        with self._lock:
            self._partitions = [(p, u) for p, u in self._partitions
                                if u > now]
            for pat, _until in self._partitions:
                if pat is None or pat in addr:
                    raise ConnectionError(
                        f"fault-injected partition: {addr} unreachable")

    def on_send(self, sock, frames):
        """Transform outgoing ``(header, payload)`` frames; may sleep,
        sever + raise, duplicate, or corrupt (a copy of) payloads."""
        addr = self._socks.get(sock)
        if addr is None:
            return frames
        out = []
        for header, payload in frames:
            rule = self._decide(addr, header)
            if rule is None:
                out.append((header, payload))
                continue
            kind = rule.kind
            if kind == "drop":
                _sever(sock)
                raise ConnectionError(
                    f"fault-injected drop (op={header.get('op')}, "
                    f"peer={addr})")
            if kind == "partition":
                until = time.monotonic() + rule.duration_s
                with self._lock:
                    self._partitions.append((rule.peer or addr, until))
                _sever(sock)
                raise ConnectionError(
                    f"fault-injected partition (peer={addr}, "
                    f"{rule.duration_s}s)")
            if kind == "delay":
                time.sleep(rule.delay_s)
                out.append((header, payload))
            elif kind == "dup":
                out.append((header, payload))
                out.append((header, payload))
            elif kind == "corrupt":
                out.append((header, self._corrupt(payload, rule.flips)))
        return out

    def on_recv(self, sock, header) -> None:
        """Receive-side hook: only ``delay`` and ``drop`` make sense once
        the bytes already arrived intact."""
        addr = self._socks.get(sock)
        if addr is None:
            return
        rule = self._decide(addr, header, kinds=("delay", "drop"))
        if rule is None:
            return
        if rule.kind == "drop":
            _sever(sock)
            raise ConnectionError(
                f"fault-injected recv drop (op={header.get('op')})")
        time.sleep(rule.delay_s)

    # -- internals ------------------------------------------------------
    def _decide(self, addr: str, header: dict,
                kinds: Optional[tuple] = None) -> Optional[FaultRule]:
        op = header.get("op")
        with self._lock:
            for rule in self.plan.wire_rules:
                if kinds is not None and rule.kind not in kinds:
                    continue
                if not rule.matches(op, addr):
                    continue
                key = id(rule)
                c = self._match_counts[key] = \
                    self._match_counts.get(key, 0) + 1
                if rule.nth is not None:
                    fire = (c == rule.nth)
                elif rule.every is not None:
                    fire = (c % rule.every == 0)
                else:
                    fire = rule.prob > 0 and self._rng.random() < rule.prob
                if fire:
                    self.fired[rule.kind] = self.fired.get(rule.kind, 0) + 1
                    return rule
        return None

    def _corrupt(self, payload, flips: int):
        parts = (payload if isinstance(payload, (list, tuple))
                 else [] if payload is None else [payload])
        buf = bytearray()
        for p in parts:
            buf += bytes(memoryview(p).cast("B"))
        if not buf:
            return payload
        with self._lock:
            idxs = [self._rng.randrange(len(buf))
                    for _ in range(max(1, flips))]
        for i in idxs:
            buf[i] ^= 0xFF
        return buf


# -- installation -------------------------------------------------------

def install(plan: FaultPlan,
            scope: Optional[Sequence[str]] = None) -> FaultInjector:
    """Build an injector for ``plan`` and hook it into the wire layer."""
    from repro_torch.core import wire
    inj = FaultInjector(plan, scope=scope)
    wire.set_fault_injector(inj)
    return inj


def uninstall() -> None:
    from repro_torch.core import wire
    wire.set_fault_injector(None)


@contextmanager
def injected(plan: FaultPlan, scope: Optional[Sequence[str]] = None):
    """``with injected(plan) as inj:`` — scoped install/uninstall."""
    inj = install(plan, scope=scope)
    try:
        yield inj
    finally:
        uninstall()
