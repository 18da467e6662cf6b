"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``LAUNCHES`` counts, per kernel, the launches of that kernel; its launcher
adds one each time it starts it. A run sets the counts to 0 before the path
it drives and reads them after, to show the path went through the kernels.
"""
from __future__ import annotations

LAUNCHES: dict[str, int] = {"flash_attention": 0, "ssm_scan": 0,
                            "staging_pack": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
