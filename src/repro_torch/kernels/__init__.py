"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``LAUNCHES`` counts, per kernel, the launches of that kernel; its launcher
adds one each time it starts it. A run sets the counts to 0 before the path
it drives and reads them after, to show the path went through the kernels.

Each launcher also hands its call's cost (``cost.py`` beside each kernel:
operations and bytes by the kernel's own formula) to ``note_cost``, where
it launches the kernel on the card and where it returns a meta tensor's
outputs without launching (the dry run), so that an op counter
(``launch.op_analysis``) counts a kernel alike on both.
"""
from __future__ import annotations

from typing import Callable

LAUNCHES: dict[str, int] = {"decode_attention": 0, "flash_attention": 0,
                            "ssm_scan": 0, "staging_pack": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the open op counters' callbacks, (kernel name, cost dict) -> None
COST_SINKS: list[Callable[[str, dict], None]] = []


def note_cost(name: str, formula: Callable[..., dict], *args) -> None:
    """Hand ``formula(*args)`` (computed only where a counter is open) to
    every open counter."""
    if COST_SINKS:
        cost = formula(*args)
        for sink in COST_SINKS:
            sink(name, cost)
