"""The flash-attention kernel's cost by its own formula: the operations of
the keys each query row sees (not the plain version's full Sq x Sk) and
the bytes of q, k, v read once and o written once. ``chip_smoke.py``'s
bound and the op counter of the dry run (``launch.op_analysis``) both read
it."""
from __future__ import annotations

import numpy as np


def visible_keys(Sq: int, Sk: int, causal: bool, window: int,
                 prefix: int = 0) -> int:
    """Sum over query rows of the keys the mask lets each row see (row i
    at position i, as the kernel's mask places it); a prefix (never with a
    window) lets every row see keys < prefix."""
    q = np.arange(Sq, dtype=np.int64)
    hi = (np.minimum(Sk, np.maximum(q + 1, prefix)) if causal
          else np.full(Sq, Sk, np.int64))
    lo = np.maximum(0, q - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.sum(np.maximum(hi - lo, 0)))


def flash_cost(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
               itemsize: int, causal: bool, window: int,
               prefix: int = 0) -> dict:
    """{"flops": 4·B·Hq·D·visible keys (two products a visible key),
    "bytes": q and o (B, Sq, Hq, D), k and v (B, Sk, Hkv, D)}."""
    return {"flops": 4 * B * Hq * D * visible_keys(Sq, Sk, causal, window, prefix),
            "bytes": B * (2 * Sq * Hq + 2 * Sk * Hkv) * D * itemsize}
