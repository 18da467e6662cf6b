"""The decode-attention kernel's cost by its own formula: two products of
2·D operations for each slot of each query head, and the bytes of K and V
read once, the slots' positions read once, q read once and the output
written once. A row's bound on the slots it reads is data (its position),
so the count takes every slot of the cache: a row at the cache's end, as
the dry run decodes; on the card it is the most a call can cost. The op
counter of the dry run (``launch.op_analysis``) reads it."""
from __future__ import annotations


def decode_cost(B: int, T: int, Hq: int, Hkv: int, D: int,
                itemsize: int) -> dict:
    """{"flops": 4·B·Hq·D·T, "bytes": k and v (B, T, Hkv, D), the slots'
    int32 positions (B, T), q and o (B, Hq, D)}."""
    return {"flops": 4 * B * Hq * D * T,
            "bytes": B * (2 * T * Hkv + 2 * Hq) * D * itemsize + 4 * B * T}
