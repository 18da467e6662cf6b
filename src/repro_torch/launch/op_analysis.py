"""Per-rank op counts of one step, the counterpart of
``repro/launch/hlo_analysis.py``.

The reference compiles a step and reads XLA's optimized HLO: it parses the
text, multiplies each computation's cost by its while loop's trip count and
sums dots, elementwise ops, post-fusion traffic and collectives. The port
has no HLO to parse: a step is eager PyTorch, and what it runs is the
sequence of aten ops the dispatcher sees. So the counter is a
``TorchDispatchMode`` that watches every op of the step as it runs, on the
meta device (the dry run: shapes only, nothing computed) or on the card
(the same step counted the same way), per rank:

  flops       2·result·contracting dims of each matmul-family op, batch
              dims included (``torch.utils.flop_counter``'s formulas, the
              twin of ``_dot_flops``), plus each hand-written kernel's own
              formula where it launches, or returns shapes on meta
              (``kernels.note_cost``);
  vpu_flops   the output elements of floating pointwise ops;
  hbm_bytes   operand plus result bytes of every op that is not a view (the
              eager twin of "top-level post-fusion ops": eager code fuses
              nothing), plus the kernels' own bytes;
  collectives bytes and counts by the reference's classes, from the mesh
              (``launch.mesh.record_collectives``);
  peak_bytes  the live bytes of the tensors' storages at their peak, the
              arguments included: each output storage is counted from the
              op that makes it until it is freed, rounded up to 512 bytes
              as the CUDA caching allocator rounds a block;
  n_ops       the ops counted (views not), in place of ``n_computations``.

XLA's ``while`` has a trip count; the port's loops run in Python and are
counted op by op as they run. The one loop too long to run on meta is the
selective scan's plain backward (a time step at a time): its meta path
(``kernels.ssm_scan.ops.scan_vjp``) counts one and two time steps with
``probe`` and adds the constant part and S times the per-step part, the
twin of ``_trip_count``/``multiplicities``.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels
from repro_torch.launch.mesh import record_collectives

_FREE = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default}       # allocate, move no bytes
_COUNTERS: list["OpCounter"] = []                 # the open counters, innermost last
KEYS = ("flops", "vpu_flops", "hbm_bytes", "n_ops")


def _block(n: int) -> int:
    """Bytes the CUDA caching allocator books for an n-byte tensor."""
    return max(512, -(-n // 512) * 512) if n else 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the ops run while it is open (module docstring). ``device``:
    the device type whose storages make up ``peak_bytes`` (all where
    None)."""

    def __init__(self, device: Optional[str] = None):
        super().__init__()
        self.device = device
        self.flops = self.vpu_flops = self.hbm_bytes = 0
        self.n_ops = 0
        self.by_op: Counter = Counter()
        self.kernels: dict[str, dict] = {}
        self.live = self.peak = 0
        self.paused = 0
        self._storages: dict[int, int] = {}

    # -- memory -------------------------------------------------------------
    def track(self, tree: Any) -> int:
        """Count the storages of the tensors of ``tree`` as live (the
        step's arguments) until they are freed; returns their bytes."""
        total = 0
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                total += self._hold(t)
        return total

    def _hold(self, t: torch.Tensor) -> int:
        if self.device is not None and t.device.type != self.device:
            return 0
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return 0
        n = _block(st.nbytes())
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def transient(self, nbytes: int) -> None:
        """Bytes alive for a moment above what is live (a counted loop's
        working set, which ``probe`` measured)."""
        self.peak = max(self.peak, self.live + nbytes)

    # -- counting -----------------------------------------------------------
    def add(self, counts: dict, times: float = 1) -> None:
        for k in KEYS:
            setattr(self, k, getattr(self, k) + counts[k] * times)

    def _kernel(self, name: str, cost: dict) -> None:
        if self.paused:
            return
        self.flops += cost["flops"]
        self.hbm_bytes += cost["bytes"]
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += cost["flops"]
        k["bytes"] += cost["bytes"]

    def __enter__(self):
        _COUNTERS.append(self)
        kernels.COST_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.COST_SINKS.remove(self._kernel)
        _COUNTERS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused or func.is_view:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.n_ops += 1
        self.by_op[str(func.overloadpacket)] += 1
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if torch.Tag.pointwise in func.tags:
            self.vpu_flops += sum(t.numel() for t in outs if t.is_floating_point())
        if func not in _FREE:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        # storages a result aliases (in-place ops, out= results) are an
        # input's, already live or an argument's
        for t, ret in zip(outs, func._schema.returns):
            if ret.alias_info is None:
                self._hold(t)
        return out

    def report(self) -> dict:
        return {"flops": float(self.flops), "vpu_flops": float(self.vpu_flops),
                "hbm_bytes": float(self.hbm_bytes), "n_ops": int(self.n_ops),
                "peak_bytes": int(self.peak), "kernels": self.kernels}


@contextlib.contextmanager
def paused():
    """Nothing run within the block is counted by any open counter."""
    for c in _COUNTERS:
        c.paused += 1
    try:
        yield
    finally:
        for c in _COUNTERS:
            c.paused -= 1


def counting() -> bool:
    return any(not c.paused for c in _COUNTERS)


def probe(fn: Callable, *args) -> dict:
    """``fn(*args)`` counted alone, every open counter paused: its counts
    (``KEYS``) and ``peak_bytes``, the most its new storages held at once."""
    with paused():
        c = OpCounter()
        with c:
            fn(*args)
        return {**{k: getattr(c, k) for k in KEYS}, "peak_bytes": c.peak}


def add_counted(counts: dict, times: float = 1) -> None:
    """Add ``counts`` ``times`` to every open counter, as if run."""
    for c in _COUNTERS:
        if not c.paused:
            c.add(counts, times)


def note_transient(nbytes: int) -> None:
    for c in _COUNTERS:
        if not c.paused:
            c.transient(nbytes)


def hold(tree: Any) -> None:
    """The storages of ``tree`` counted as made here (tensors made while
    the counters were paused that stand for counted ones)."""
    for c in _COUNTERS:
        if not c.paused:
            c.track(tree)


def tree_bytes(tree: Any) -> int:
    return sum(_nbytes(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def analyze(fn: Callable, *args, device: Optional[str] = None,
            by_op: bool = False) -> tuple[Any, dict]:
    """(``fn(*args)``, its counts): the reference's keys ``flops``,
    ``vpu_flops``, ``hbm_bytes``, ``collective_bytes``,
    ``collective_counts`` and ``collective_total`` (and the bytes by
    dtype, ``collective_dtype_bytes``), and ``n_ops``,
    ``peak_bytes`` (``args`` counted live from the start),
    ``argument_bytes``, ``output_bytes`` and ``kernels`` (each kernel's
    calls, flops and bytes); with ``by_op`` each op's count."""
    counter = OpCounter(device)
    argument_bytes = tree_bytes(args)
    counter.track(args)
    with record_collectives() as rec, counter:
        out = fn(*args)
    report = counter.report()
    report.update(collective_bytes=rec["bytes"], collective_counts=rec["counts"],
                  collective_total=sum(rec["bytes"].values()),
                  collective_dtype_bytes=rec["dtype_bytes"],
                  argument_bytes=argument_bytes, output_bytes=tree_bytes(out))
    if by_op:
        report["by_op"] = dict(counter.by_op)
    return out, report
