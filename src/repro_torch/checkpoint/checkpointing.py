"""Checkpointing, asynchronous and riding the paper's staging path: the
port of ``repro/checkpoint/checkpointing.py`` on one device.

The on-disk layout is the reference's, so each side restores the other's
checkpoints: ``step_%08d/`` holds ``manifest.json`` ({"step", "leaves":
{key: {"shape", "dtype"}}}), one ``a__b.npy`` per leaf (the key's "/" as
"__") and, once every file is written, ``COMMITTED``; the newest ``keep``
committed steps are kept. Keys are the tree's path, dict keys joined by
"/". A list in the port's tree (a ``scan`` entry's periods) is stored as the
reference holds it: one leaf per key, stacked on a leading periods axis.

``save`` copies every leaf to host numpy before it returns, so the caller
may update its tensors in place at once; the file writes run on the port's
``FCFSPool`` and, with a sink, every leaf is also staged into SAVIME
(queryable in place).

On a mesh (``layout``, the ``TrainSetup`` of the run) every rank calls
``save``, ``wait`` and ``restore`` at the same step: ``save`` gathers the
whole state (ZeRO-1 moments, each pod's residual) to rank 0 alone, which
writes it; ``wait`` ends with a barrier, so that every rank then reads what rank 0
committed; ``restore`` reads the whole state and gives each rank its share
for the mesh it runs on, whatever mesh wrote it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.convert import tensor_from_numpy, to_reference_layout
from repro_torch.core.intransit import InTransitSink
from repro_torch.core.queues import FCFSPool
from repro_torch.device import resolve_device
from repro_torch.models.layers import ParamSpec, to_dtype, unstack

Tree = Any


def _flatten(tree: Tree, prefix: str = "") -> dict[str, Any]:
    """{key: leaf} of a tree of dicts, the keys in sorted order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def _leaf_file(cdir: str, key: str) -> str:
    return os.path.join(cdir, key.replace("/", "__") + ".npy")


class CheckpointManager:
    def __init__(self, directory: str, sink: Optional[InTransitSink] = None,
                 keep: int = 3, async_writes: bool = True, layout=None):
        self.dir = directory
        self.sink = sink
        self.keep = keep
        self.layout = layout
        mesh = getattr(layout, "mesh", None)
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        os.makedirs(directory, exist_ok=True)
        self._pool = FCFSPool(2, "ckpt-io") if async_writes else None
        self._lock = threading.Lock()

    # -- save ---------------------------------------------------------------
    def save(self, state: Tree, step: int) -> str:
        """Non-blocking (async_writes): the device->host copy happens here,
        file and staging I/O on background threads. On a mesh, collective;
        rank 0 writes."""
        cdir = os.path.join(self.dir, f"step_{step:08d}")
        if self.layout is not None:
            state = self.layout.whole_state(state, root=True)
        if not self.writer:
            return cdir
        host = _flatten(to_reference_layout(state))
        os.makedirs(cdir, exist_ok=True)
        manifest = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                    for k, v in host.items()}
        with open(os.path.join(cdir, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)

        def write_all():
            for k, v in host.items():
                np.save(_leaf_file(cdir, k), v)
            with open(os.path.join(cdir, "COMMITTED"), "w") as f:
                f.write("ok")
            self._gc()

        if self._pool:
            self._pool.submit(write_all, name=f"ckpt-{step}")
        else:
            write_all()
        if self.sink is not None:  # analyzable checkpoint via SAVIME
            for k, v in host.items():
                if v.ndim >= 1 and v.size > 0:
                    self.sink.stage_array("ckpt_" + k.replace("/", "_"),
                                          v, step=step)
        return cdir

    def wait(self) -> None:
        if self._pool:
            self._pool.sync()
        if self.sink:
            self.sink.flush()
        if self.mesh is not None:
            self.mesh.barrier()

    def close(self) -> None:
        """Finish the pending writes and stop the I/O threads."""
        if self._pool:
            self._pool.sync()
            self._pool.stop()

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "COMMITTED")):
                steps.append(int(d.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, abstract_state: Tree, step: Optional[int] = None,
                device: str | torch.device = "cuda") -> Tree:
        """The state of ``step`` (the latest committed by default) on
        ``device``, in the layout of ``abstract_state``: a tree of
        ``ParamSpec`` whose lists (per-period ``scan`` entries) are read from
        one stacked leaf each. Leaves are cast to the spec's dtype. With a
        ``layout``, ``abstract_state`` is the whole state's and the result
        this rank's share of it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        cdir = os.path.join(self.dir, f"step_{step:08d}")
        dev = resolve_device(device)

        def load(spec_tree, key):
            if isinstance(spec_tree, dict):
                return {k: load(v, f"{key}/{k}" if key else str(k))
                        for k, v in spec_tree.items()}
            if isinstance(spec_tree, list):
                stacked = load(_stacked_spec(spec_tree), key)
                return unstack(stacked, len(spec_tree))
            arr = np.load(_leaf_file(cdir, key)).reshape(spec_tree.shape)
            return tensor_from_numpy(arr, dev).to(to_dtype(spec_tree.dtype))

        whole = load(abstract_state, "")
        return whole if self.layout is None else self.layout.local_state(whole)

    def _gc(self) -> None:
        with self._lock:
            steps = sorted(
                int(d.split("_")[1]) for d in os.listdir(self.dir)
                if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "COMMITTED")))
            for s in steps[:-self.keep]:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                              ignore_errors=True)


def _stacked_spec(per_period: list) -> Tree:
    """Per-period spec trees -> one tree of specs with the periods axis."""
    first = per_period[0]
    if isinstance(first, dict):
        return {k: _stacked_spec([p[k] for p in per_period]) for k in first}
    return ParamSpec((len(per_period), *first.shape), first.dtype, first.init)
