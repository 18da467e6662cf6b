"""Run a function on every rank of a gloo world: one process a rank.

``run_ranks(fn, world, *args)`` starts ``world`` processes with the
``spawn`` start method (never ``fork``: the caller may have initialised
CUDA), joins them into one ``torch.distributed`` world over a file store in
a fresh temporary directory (no port to clash with another run), calls
``fn(*args)`` on each and returns what each returned, in rank order. ``fn``
must be importable (a module's top-level function) and its results
picklable; CUDA tensors do not cross, numbers, numpy arrays and CPU
tensors do. A rank that raises makes the whole run raise with its
traceback, and the other ranks are stopped.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 600


def _rank_main(rank: int, fn: Callable, world: int, store_dir: str,
               args: tuple) -> None:
    # an even share of the machine's cores for each rank's CPU ops
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    # every rank is on this machine: gloo talks over the loopback interface,
    # whatever the host name resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(store_dir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = ("ok", fn(*args))
    except BaseException:           # reported to the parent, then re-raised
        result = ("error", traceback.format_exc())
        _dump(store_dir, rank, result)
        raise
    finally:
        dist.destroy_process_group()
    _dump(store_dir, rank, result)


def _dump(store_dir: str, rank: int, result: tuple) -> None:
    with open(os.path.join(store_dir, f"rank-{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, world: int, *args: Any) -> list:
    """``[fn(*args) on rank r for r in range(world)]``, each in its own
    process of one gloo world."""
    with tempfile.TemporaryDirectory(prefix="repro-torch-ranks-") as d:
        try:
            mp.start_processes(_rank_main, args=(fn, world, d, args),
                               nprocs=world, join=True, start_method="spawn")
        except mp.ProcessRaisedException as e:
            raise RuntimeError(f"a rank of {world} failed:\n{e}") from None
        out = []
        for r in range(world):
            with open(os.path.join(d, f"rank-{r}.pkl"), "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
            out.append(value)
    return out
