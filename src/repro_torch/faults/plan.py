"""FaultPlan — the deterministic, seeded fault schedule (DESIGN.md §15).

A plan is a seed plus an ordered list of :class:`FaultRule`.  Each rule
names a fault ``kind`` and how it triggers:

  kind        effect at the wire boundary
  ----        ---------------------------
  drop        sever the connection instead of sending the frame (a
              silent frame drop would desync the FIFO ack protocol, so
              "drop" on a stream transport means "the link died here")
  delay       sleep ``delay_s`` before the frame goes out
  dup         send the frame twice (servers must dedup)
  corrupt     flip ``flips`` random bytes in a *copy* of the payload
  partition   fail every ``connect`` to the matched peer for
              ``duration_s`` (and sever the triggering connection)
  kill        scheduled process death: at ``at_s`` seconds after the
              scheduler starts, invoke the named ``target``'s kill hook
              (``staging:0``, ``savime:1``, ``gateway``, ...)

Trigger selection per matching frame: ``nth`` fires exactly on the n-th
match (1-based), ``every`` fires on every k-th match, otherwise ``prob``
fires with that probability from the plan's seeded RNG.  Matching is by
frame ``op`` (None = any) and peer address substring (None = any peer).

Plans are built in code (tests), or parsed from the compact spec string
the ``--faults`` launcher flag takes::

    seed=42;drop:op=stripe,prob=0.01;kill:target=staging:0,at_s=0.5

or from a JSON file (``--faults plan.json``) holding
``{"seed": 42, "rules": [{"kind": "drop", "op": "stripe", ...}]}``.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Optional

KINDS = ("drop", "delay", "dup", "corrupt", "partition", "kill")

_FLOAT_KEYS = ("prob", "delay_s", "duration_s", "at_s")
_INT_KEYS = ("nth", "every", "flips")


@dataclass
class FaultRule:
    """One fault: what it does (``kind``) and when it fires."""

    kind: str
    op: Optional[str] = None          # frame op to match (None = any)
    peer: Optional[str] = None        # substring of the peer addr
    nth: Optional[int] = None         # fire on exactly the n-th match
    every: Optional[int] = None       # fire on every k-th match
    prob: float = 0.0                 # else: fire with this probability
    delay_s: float = 0.0              # kind=delay
    flips: int = 1                    # kind=corrupt
    duration_s: float = 0.25          # kind=partition
    at_s: float = 0.0                 # kind=kill
    target: Optional[str] = None      # kind=kill

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.kind == "kill" and not self.target:
            raise ValueError("kill rule requires target=")

    def matches(self, op: Optional[str], peer: Optional[str]) -> bool:
        if self.op is not None and op != self.op:
            return False
        if self.peer is not None and (peer is None or self.peer not in peer):
            return False
        return True


@dataclass
class FaultPlan:
    """Seeded RNG + rules; reusable across tests, launchers and benches."""

    seed: int = 0
    rules: list = field(default_factory=list)

    @property
    def kill_rules(self) -> list:
        return [r for r in self.rules if r.kind == "kill"]

    @property
    def wire_rules(self) -> list:
        return [r for r in self.rules if r.kind != "kill"]

    def encode(self) -> dict:
        return {"seed": self.seed, "rules": [asdict(r) for r in self.rules]}

    @classmethod
    def decode(cls, obj: dict) -> "FaultPlan":
        return cls(seed=int(obj.get("seed", 0)),
                   rules=[FaultRule(**r) for r in obj.get("rules", ())])

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the ``--faults`` argument: a spec string or a JSON path."""
        spec = spec.strip()
        if spec.endswith(".json") or os.path.isfile(spec):
            with open(spec) as f:
                return cls.decode(json.load(f))
        seed, rules = 0, []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            if part.startswith("seed="):
                seed = int(part[5:])
                continue
            kind, _, argstr = part.partition(":")
            kwargs: dict = {}
            for kv in filter(None, (a.strip() for a in argstr.split(","))):
                k, _, v = kv.partition("=")
                if k in _FLOAT_KEYS:
                    kwargs[k] = float(v)
                elif k in _INT_KEYS:
                    kwargs[k] = int(v)
                elif k in ("op", "peer", "target"):
                    kwargs[k] = v
                else:
                    raise ValueError(f"unknown fault rule key {k!r} in "
                                     f"{part!r}")
            rules.append(FaultRule(kind=kind, **kwargs))
        return cls(seed=seed, rules=rules)
