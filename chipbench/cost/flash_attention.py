"""Attention's work from its shapes: two products (q k^T and p v) of
2 * D operations for each key a query row sees under the mask, and the
bytes of q, k and v read once and the output written once. The mask is
causal with the rows at the ends of their keys (row i of Sq sees keys
0 .. Sk - Sq + i)."""
from __future__ import annotations

from chipbench.cost import peaks


def visible_keys(Sq: int, Sk: int) -> int:
    """Sum over the query rows of the keys each sees under a causal mask."""
    off = Sk - Sq
    return Sq * (off + 1) + Sq * (Sq - 1) // 2


def cost(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
         itemsize: int = 2) -> dict:
    return {"flops": 4 * B * Hq * D * visible_keys(Sq, Sk),
            "bytes": B * (2 * Sq * Hq + 2 * Sk * Hkv) * D * itemsize}


def least_seconds(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int) -> float:
    c = cost(B, Sq, Sk, Hq, Hkv, D)
    return peaks.least_seconds(flops=c["flops"], nbytes=c["bytes"])
