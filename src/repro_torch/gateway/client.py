"""GatewayClient — the redirect-capable client's view of the gateway.

A gateway-aware producer keeps exactly one control connection to the
gateway and sends every *data* byte straight to the backend the gateway
admits it to — the redirect protocol (DESIGN.md §12). Per dataset that
costs one ``admit`` round-trip (auth + quota + placement) and preserves
the one-sided RDMA data plane end-to-end: the backend's ``write_req`` /
``stripe_open`` replies still carry a locally-mappable region path, so
payload bytes never traverse the gateway.

The client also caches the placement ring locally. Placement is pure
(BLAKE2b; see :mod:`repro_torch.gateway.ring`), so the cached ring predicts
the gateway's decisions for free — the Coalescer uses it to pre-group
small datasets — while the authoritative answer remains the gateway's
``admit`` reply. Every admit carries the current ring ``epoch``; an
epoch mismatch (a backend joined/left) refreshes the cache.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

from repro_torch.core import wire
from repro_torch.core.retry import RetryPolicy
from repro_torch.gateway.ring import HashRing, RingNode
from repro_torch.gateway.tenancy import error_from_reply


class GatewayClient:
    """One locked control connection + a cached placement ring."""

    def __init__(self, addr: str, tenant: Optional[str] = None, *,
                 retry: Optional[RetryPolicy] = None):
        self.addr = addr
        self.tenant = tenant
        self._lock = threading.Lock()
        self._retry = retry or RetryPolicy()
        self._sock = wire.connect(addr)
        self.ring: Optional[HashRing] = None
        self.epoch: Optional[str] = None
        self.refresh()

    # -- control-plane RTTs ---------------------------------------------
    def _request(self, header: dict) -> dict:
        if self.tenant and "tenant" not in header:
            header = dict(header, tenant=self.tenant)
        for attempt in self._retry.attempts(f"gateway {header.get('op')}"):
            try:
                # the lock serializes request/reply pairs on the one
                # control conn — blocking under it is the point
                with self._lock:  # lint: ignore[io-under-lock]
                    h, _ = wire.request(self._sock, header)
                break
            except (ConnectionError, TimeoutError, OSError) as e:
                attempt.backoff(e)          # jittered sleep, outside _lock
                try:
                    self._reconnect()
                except (ConnectionError, OSError):
                    pass    # still down: the next attempt backs off again
        if not h.get("ok"):
            raise error_from_reply(h, f"gateway {header.get('op')} failed")
        return h

    def _reconnect(self) -> None:
        # the dial under the lock *is* the serialisation: concurrent
        # _request retries must not race a half-swapped control conn
        with self._lock:  # lint: ignore[io-under-lock]
            old, self._sock = self._sock, wire.connect(self.addr)
        try:
            old.close()
        except OSError:
            pass

    def refresh(self) -> HashRing:
        """Re-fetch the authoritative ring (join/leave happened)."""
        h = self._request({"op": "ring"})
        ring = HashRing.decode(h["ring"])
        self.ring, self.epoch = ring, ring.epoch
        return ring

    def _adopt_epoch(self, h: dict) -> None:
        epoch = h.get("epoch")
        if epoch and epoch != self.epoch:
            try:
                self.refresh()
            except (OSError, RuntimeError):
                pass     # stale cache only costs extra refreshes, not data

    def admit(self, name: str, size: int,
              epoch: Optional[str] = None) -> str:
        """Admit one dataset (auth + quota + placement); returns the
        backend address the data plane must target. ``epoch`` is the
        producer's replay identity: a re-admit of the same (name, epoch)
        is not re-charged against the tenant, and the gateway moves the
        parity accounting if placement changed (backend fail-out)."""
        req = {"op": "admit", "name": name, "size": int(size)}
        if epoch is not None:
            req["epoch"] = str(epoch)
        h = self._request(req)
        self._adopt_epoch(h)
        return h["addr"]

    def admit_batch(self, items: Sequence[tuple[str, int]]) -> list[str]:
        """Admit N datasets in one RTT (the Coalescer's flush path);
        all-or-nothing against quota. Returns one backend address per
        item, in order."""
        h = self._request({"op": "admit_batch",
                           "items": [{"name": n, "size": int(s)}
                                     for n, s in items]})
        self._adopt_epoch(h)
        return list(h["addrs"])

    # -- local (RTT-free) placement -------------------------------------
    def place(self, name: str) -> RingNode:
        """Predicted owner from the cached ring (grouping hint only —
        ``admit`` is the authority)."""
        if self.ring is None or not len(self.ring):
            raise RuntimeError("gateway ring cache is empty")
        return self.ring.place(name)

    def stats(self) -> dict:
        return self._request({"op": "stats"})

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
