"""Block planner — the paper's central knob (RDMA block size, Fig 3/4).

Also provides the analytic transfer-cost model used for §Perf napkin math
and property tests: elapsed(nbytes, block) should fall monotonically with
block size (paper claim C1) because the per-block costs (registration RTT +
on-demand memory registration) amortize.

On TPU the same knob becomes the Pallas BlockSpec tile of the egress pack
kernel — `vmem_tile` aligns a block to (sublane, lane) = (8·dtype, 128)
multiples so the MXU/VPU see hardware-aligned shapes.
"""
from __future__ import annotations

import dataclasses
import math


def plan_blocks(nbytes: int, block_size: int) -> list[tuple[int, int]]:
    """[(offset, size)] covering nbytes; last block may be short."""
    if nbytes < 0 or block_size <= 0:
        raise ValueError((nbytes, block_size))
    if nbytes == 0:
        return []
    return [(off, min(block_size, nbytes - off))
            for off in range(0, nbytes, block_size)]


def vmem_tile(block_elems: int, dtype_bytes: int, lane: int = 128,
              sublane_bytes: int = 32) -> tuple[int, int]:
    """(rows, 128) tile whose footprint ≲ block_elems elements, rows a
    multiple of the dtype's sublane packing (32 bytes / dtype size)."""
    sublane = max(sublane_bytes // dtype_bytes, 1)
    rows = max(block_elems // lane, sublane)
    rows -= rows % sublane
    return (max(rows, sublane), lane)


@dataclasses.dataclass(frozen=True)
class TransferCostModel:
    """elapsed = n_blocks·(rtt + reg_fixed) + nbytes·(1/bw + reg_per_byte)

    rtt:          control round-trip per block grant (s)
    reg_fixed:    fixed on-demand registration cost per block (s)
    reg_per_byte: page-pinning cost per byte (s/B)
    bw:           link bandwidth (B/s)
    """
    rtt: float = 50e-6
    reg_fixed: float = 20e-6
    reg_per_byte: float = 1 / (30e9)
    bw: float = 12.5e9          # ~100 Gb/s Infiniband-ish

    def predict(self, nbytes: int, block_size: int) -> float:
        n_blocks = max(1, math.ceil(nbytes / block_size))
        return (n_blocks * (self.rtt + self.reg_fixed)
                + nbytes * (1.0 / self.bw + self.reg_per_byte))

    def best_block(self, nbytes: int, candidates: list[int]) -> int:
        return min(candidates, key=lambda b: self.predict(nbytes, b))
