"""Device meshes on ``torch.distributed``, the port of
``repro/launch/mesh.py``.

A ``Mesh`` names the axes of the world's ranks in row-major order, as the
reference lays ``jax.devices()`` out: rank r sits at
``np.unravel_index(r, shape)``. Each axis has a process group (the ranks
that differ from this one in that coordinate only), and ``dp`` is the group
of the data-parallel axes ``pod`` and ``data`` together, ordered pod-major
as the reference's ``P(("pod", "data"))`` orders a batch's rows.

The groups are gloo's, never NCCL's: NCCL refuses two ranks on one GPU, and
one card may hold every rank. gloo's point-to-point takes CPU tensors only,
so the collectives below move a CUDA tensor through a pinned host buffer
(``AxisGroup``); the time of those copies belongs to the wire.

``model`` > 1 gives tensor and expert parallelism to serving and training
(``train.sharding.TPContext``). A mesh of one rank needs no process group
and runs without ``torch.distributed``.

``AbstractMesh`` is the dry run's mesh (``launch.dryrun``), the twin of
the reference's ``AbstractMesh``: any shape, one rank's coordinates, no
world. Its collectives move nothing and give tensors of the right shape.

Every collective, real or abstract, is noted under the reference's HLO
classes while ``record_collectives()`` is open: its wire bytes (the larger
of the result and the operands, as ``hlo_analysis`` counts them) and a
count of one. A real run's record can so be held against a dry run's.
gloo has no reduce-scatter: ``all_reduce_sum`` and ``all_gather`` are
``all-reduce`` and ``all-gather``, ``gather`` to one rank an
``all-gather``, and ``send_to``, ``broadcast`` and a ring hop
(``exchange``) a ``collective-permute``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_RECORDS: list[dict] = []   # the open records, innermost last


def new_record() -> dict:
    return {"bytes": dict.fromkeys(COLLECTIVES, 0),
            "counts": dict.fromkeys(COLLECTIVES, 0),
            "dtype_bytes": {k: {} for k in COLLECTIVES}}


@contextlib.contextmanager
def record_collectives() -> Iterator[dict]:
    """Yields a record {"bytes": {class: n}, "counts": {class: n},
    "dtype_bytes": {class: {dtype: n}}} that every collective of this
    process adds to until the block ends."""
    rec = new_record()
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _note(kind: str, result: int, operands: int, t: torch.Tensor) -> None:
    wire = max(result, operands)
    for rec in _RECORDS:
        rec["bytes"][kind] += wire
        rec["counts"][kind] += 1
        by = rec["dtype_bytes"][kind]
        by[str(t.dtype)] = by.get(str(t.dtype), 0) + wire


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself on the CPU; a CUDA tensor's copy in pinned host memory
    (PyTorch's caching host allocator reuses the buffers across steps)."""
    if t.device.type == "cpu":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _to_device(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return host if like.device.type == "cpu" else host.to(like.device)


class AxisGroup:
    """The ranks along one or more mesh axes that share every other
    coordinate with this rank: ``ranks`` (global, in axis order), this
    rank's ``index`` among them, and gloo's group (None for one rank)."""

    def __init__(self, ranks: list[int], index: int,
                 group: Optional[dist.ProcessGroup]):
        self.ranks, self.index, self.group = ranks, index, group

    @property
    def size(self) -> int:
        return len(self.ranks)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """In place: ``t`` becomes the sum over the group (every rank gets
        the same bits: gloo's ring reduces each chunk once)."""
        if self.size == 1:
            return t
        _note("all-reduce", _nbytes(t), _nbytes(t), t)
        host = _to_host(t)
        dist.all_reduce(host, group=self.group)
        if host is not t:
            t.copy_(host)
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (same shape and dtype), in group order, on
        ``t``'s device."""
        if self.size == 1:
            return [t]
        _note("all-gather", self.size * _nbytes(t), _nbytes(t), t)
        host = _to_host(t)
        outs = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(outs, host, group=self.group)
        return [_to_device(o, t) for o in outs]

    def gather(self, t: torch.Tensor, dst: int = 0) -> Optional[list[torch.Tensor]]:
        """Every rank's ``t`` (same shape and dtype), in group order, on
        ``t``'s device on the group's ``dst``-th rank; None on the others."""
        if self.size == 1:
            return [t]
        _note("all-gather", self.size * _nbytes(t), _nbytes(t), t)
        host = _to_host(t)
        outs = ([torch.empty_like(host) for _ in range(self.size)]
                if self.index == dst else None)
        dist.gather(host, outs, dst=self.ranks[dst], group=self.group)
        return None if outs is None else [_to_device(o, t) for o in outs]

    def send_to(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """In place on the group's ``dst``-th rank: ``t`` becomes its
        ``src``-th rank's ``t``. Only those two ranks take part."""
        if src == dst or self.index not in (src, dst):
            return t
        _note("collective-permute", _nbytes(t), _nbytes(t), t)
        host = _to_host(t)
        if self.index == src:
            dist.send(host, self.ranks[dst], group=self.group)
            return t
        dist.recv(host, self.ranks[src], group=self.group)
        if host is not t:
            t.copy_(host)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """In place: ``t`` becomes the group's ``src``-th rank's ``t``."""
        if self.size == 1:
            return t
        _note("collective-permute", _nbytes(t), _nbytes(t), t)
        host = _to_host(t)
        dist.broadcast(host, self.ranks[src], group=self.group)
        if host is not t:
            t.copy_(host)
        return t

    def exchange(self, send: torch.Tensor, to: int, recv: torch.Tensor,
                 frm: int) -> None:
        """Send ``send`` (a CPU tensor) to the group's ``to``-th rank while
        receiving ``recv`` (CPU, filled in place) from its ``frm``-th: one
        hop of a ring."""
        _note("collective-permute", _nbytes(recv), _nbytes(send), send)
        ops = [dist.P2POp(dist.isend, send, self.ranks[to], self.group),
               dist.P2POp(dist.irecv, recv, self.ranks[frm], self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()


class Mesh:
    """``shape`` is a dict {axis: size} in axis order, as the reference's
    ``mesh.shape``; ``coords`` this rank's coordinate on each axis;
    ``groups[axis]`` its ``AxisGroup`` along that axis; ``dp`` along the
    data-parallel axes together. Every rank of the world builds the mesh,
    after ``dist.init_process_group`` when the mesh has more than one
    rank."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        n = math.prod(self.shape.values())
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != n:
            raise RuntimeError(f"mesh {self.shape} needs {n} ranks; the world "
                               f"has {world}")
        self.size = n
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self._build_groups()

    def _build_groups(self) -> None:
        grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, grid.shape))))
        self.groups = {a: self._group(grid, (a,)) for a in self.axis_names}
        self.dp = self._group(grid, dp_axes(self))

    def _group(self, grid: np.ndarray, axes: tuple[str, ...]) -> AxisGroup:
        """The AxisGroup along ``axes``. Every rank creates every such group
        (``dist.new_group`` is collective) in the same order."""
        pos = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(grid.ndim) if i not in pos]
        moved = np.moveaxis(grid, rest + pos, list(range(grid.ndim)))
        lines = moved.reshape(-1, math.prod(grid.shape[i] for i in pos) if pos else 1)
        mine = None
        for line in lines:
            ranks = [int(r) for r in line]
            group = self._new_group(ranks)
            if self.rank in ranks:
                mine = self._axis_group(ranks, ranks.index(self.rank), group)
        return mine

    def _new_group(self, ranks: list[int]) -> Optional[dist.ProcessGroup]:
        return (dist.new_group(ranks, backend="gloo")
                if len(ranks) > 1 and dist.is_initialized() else None)

    _axis_group = AxisGroup

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


class AbstractAxisGroup(AxisGroup):
    """An ``AxisGroup`` of an ``AbstractMesh``: the same ``ranks``,
    ``index`` and ``size``; each collective is noted as the real one is and
    moves nothing (an all-gather's other parts are uninitialised tensors of
    the right shape)."""

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            _note("all-reduce", _nbytes(t), _nbytes(t), t)
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        if self.size == 1:
            return [t]
        _note("all-gather", self.size * _nbytes(t), _nbytes(t), t)
        return [t if i == self.index else torch.empty_like(t)
                for i in range(self.size)]

    def gather(self, t: torch.Tensor, dst: int = 0) -> Optional[list[torch.Tensor]]:
        if self.size == 1:
            return [t]
        _note("all-gather", self.size * _nbytes(t), _nbytes(t), t)
        return (None if self.index != dst else
                [t if i == self.index else torch.empty_like(t)
                 for i in range(self.size)])

    def send_to(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        if src != dst and self.index in (src, dst):
            _note("collective-permute", _nbytes(t), _nbytes(t), t)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        if self.size > 1:
            _note("collective-permute", _nbytes(t), _nbytes(t), t)
        return t

    def exchange(self, send: torch.Tensor, to: int, recv: torch.Tensor,
                 frm: int) -> None:
        _note("collective-permute", _nbytes(recv), _nbytes(send), send)


class AbstractMesh(Mesh):
    """A mesh of any shape seen from one rank (``rank``, 0 by default),
    with no world: the reference's ``jax.sharding.AbstractMesh``. Its
    groups are ``AbstractAxisGroup``s."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 rank: int = 0):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on mesh {self.shape}")
        self.rank = rank
        self._build_groups()

    def _new_group(self, ranks: list[int]) -> None:
        return None

    _axis_group = AbstractAxisGroup

    def barrier(self) -> None:
        pass


def abstract_mesh(spec: str, rank: int = 0) -> AbstractMesh:
    """The ``AbstractMesh`` a launcher's ``--mesh`` names (``single``,
    ``multi``, ``DxM`` or ``PxDxM``), seen from ``rank``."""
    return AbstractMesh(*parse_mesh(spec), rank=rank)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 ranks a pod; 2x16x16 = 512 multi-pod. Raises, as the
    reference does, when the world is not that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(f"need {n} devices for mesh {shape}, have {world}")
    return Mesh(shape, axes)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0) -> Mesh:
    """The reference's small meshes: (data, model), or (pod, data, model)
    with ``pod``."""
    if pod:
        return Mesh((pod, data, model), ("pod", "data", "model"))
    return Mesh((data, model), ("data", "model"))


def build_mesh(spec: str) -> Mesh:
    """The mesh a launcher's ``--mesh`` names, built on this rank (after
    ``init_process_group`` when it has more than one rank)."""
    if spec in ("single", "multi"):
        return make_production_mesh(multi_pod=spec == "multi")
    return Mesh(*parse_mesh(spec))


def rank_device(device: str) -> torch.device:
    """This rank's device: the CPU, or the card ``rank % cards``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``DxM`` or ``PxDxM`` -> (shape, axes), the launcher's ``--mesh``
    debug sizes; ``single`` and ``multi`` are the production meshes."""
    if spec == "single":
        return (16, 16), ("data", "model")
    if spec == "multi":
        return (2, 16, 16), ("pod", "data", "model")
    try:
        parts = tuple(int(x) for x in spec.split("x"))
    except ValueError:
        parts = ()
    if len(parts) not in (2, 3) or min(parts) < 1:
        raise ValueError(f"mesh {spec!r}: want DxM, PxDxM, single or multi")
    if len(parts) == 2:
        return parts, ("data", "model")
    return parts, ("pod", "data", "model")

