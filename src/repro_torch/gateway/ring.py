"""Consistent-hash placement ring — the gateway's pure placement core.

Datasets map to staging backends through a classic virtual-node hash
ring (Karger et al.; the shape every staging fabric from DataSpaces to
memcached pools converges on): each backend contributes ``round(vnodes
* weight)`` points hashed onto a 64-bit circle, and a dataset lands on
the first point clockwise of its own hash. Properties the gateway (and
the property tests) rely on:

  * **deterministic across processes** — hashes are BLAKE2b over the
    node/key text, never Python's seeded ``hash()``; two gateways (or a
    gateway and a client-side cache) built from the same node set place
    every key identically;
  * **minimal disruption** — adding or removing one of N equal nodes
    remaps ~K/N of K keys; everything else stays put (contrast a modulo
    scheme, which remaps nearly everything);
  * **capacity weights** — a node with ``weight=2.0`` owns ~2x the
    arc, so heterogeneous staging servers fill proportionally.

The ring is immutable: membership changes build a new ring
(:meth:`with_node` / :meth:`without_node`).  Every distinct node set has
a deterministic :attr:`epoch` digest carried on the wire, so a client
caching placements can detect staleness with an equality check instead
of re-fetching the whole ring per admit.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
from typing import Iterable, Optional

DEFAULT_VNODES = 64


def _h64(text: str) -> int:
    """64-bit position on the ring — BLAKE2b so placement is identical in
    every process (``hash()`` is salted per interpreter)."""
    digest = hashlib.blake2b(text.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "big")


@dataclasses.dataclass(frozen=True)
class RingNode:
    """One staging backend: data-plane address, its analytical endpoint,
    and a relative capacity weight."""

    name: str
    addr: str                   # StagingServer host:port (data + control)
    savime_addr: str = ""       # SAVIME behind this backend (query fan-out)
    weight: float = 1.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class HashRing:
    """Immutable consistent-hash ring over :class:`RingNode`s."""

    def __init__(self, nodes: Iterable[RingNode],
                 vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        by_name: dict[str, RingNode] = {}
        for n in nodes:
            if n.name in by_name:
                raise ValueError(f"duplicate ring node {n.name!r}")
            if n.weight <= 0:
                raise ValueError(
                    f"node {n.name!r} weight must be > 0, got {n.weight}")
            by_name[n.name] = n
        # canonical order: ring identity (and the epoch digest) must not
        # depend on the order the caller listed the nodes in
        self.nodes: tuple[RingNode, ...] = tuple(
            by_name[k] for k in sorted(by_name))
        self.vnodes = vnodes
        points: list[tuple[int, str, RingNode]] = []
        for node in self.nodes:
            replicas = max(1, round(vnodes * node.weight))
            for r in range(replicas):
                # node name ties (hash collisions) break by name so the
                # ring order is still total and deterministic
                points.append((_h64(f"{node.name}#{r}"), node.name, node))
        points.sort(key=lambda p: (p[0], p[1]))
        self._hashes = [p[0] for p in points]
        self._owners = [p[2] for p in points]

    # -- placement ------------------------------------------------------
    def place(self, key: str) -> RingNode:
        """The backend owning ``key`` (first vnode clockwise)."""
        if not self._hashes:
            raise RuntimeError("cannot place on an empty ring")
        i = bisect.bisect_right(self._hashes, _h64(key))
        return self._owners[i % len(self._owners)]

    def node(self, name: str) -> Optional[RingNode]:
        for n in self.nodes:
            if n.name == name:
                return n
        return None

    def __len__(self) -> int:
        return len(self.nodes)

    def __contains__(self, name: str) -> bool:
        return self.node(name) is not None

    # -- membership (pure: build a new ring) ----------------------------
    def with_node(self, node: RingNode) -> "HashRing":
        return HashRing([n for n in self.nodes if n.name != node.name]
                        + [node], self.vnodes)

    def without_node(self, name: str) -> "HashRing":
        return HashRing([n for n in self.nodes if n.name != name],
                        self.vnodes)

    # -- wire encoding / staleness detection ----------------------------
    @property
    def epoch(self) -> str:
        """Deterministic digest of the membership (node set + weights +
        vnodes). Two rings place identically iff their epochs match, so
        clients cache placements and compare epochs instead of rings."""
        canon = json.dumps(
            [self.vnodes, [[n.name, n.addr, n.savime_addr, n.weight]
                           for n in self.nodes]],
            separators=(",", ":"))
        return hashlib.blake2b(canon.encode("utf-8"),
                               digest_size=8).hexdigest()

    def encode(self) -> dict:
        """JSON-safe wire form (the gateway's ``ring`` op reply)."""
        return {"vnodes": self.vnodes, "epoch": self.epoch,
                "nodes": [n.as_dict() for n in self.nodes]}

    @classmethod
    def decode(cls, d: dict) -> "HashRing":
        ring = cls([RingNode(**n) for n in d.get("nodes", ())],
                   vnodes=int(d.get("vnodes", DEFAULT_VNODES)))
        epoch = d.get("epoch")
        if epoch and ring.epoch != epoch:
            raise ValueError(
                f"ring epoch mismatch after decode: {ring.epoch} != {epoch}")
        return ring
