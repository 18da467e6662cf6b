"""A dense layer's model FLOPs and cache bytes (Qwen2's block): the four
attention projections and the three SwiGLU products, two operations a
multiply-add, and causal attention over the keys each new row sees; the
KV cache up to each row's position, in bfloat16, once."""
from __future__ import annotations

from chipbench.cost import flash_attention
from chipbench.reference import dense


def flops(c: dict, B: int, S: int, past: int) -> float:
    """B rows of S new tokens, each row after ``past`` cached tokens."""
    d = dense.dims(c)
    M, Hq, Hkv, D, F = d["M"], d["Hq"], d["Hkv"], d["D"], d["F"]
    products = M * Hq * D * 2 + M * Hkv * D * 2 + 3 * M * F
    attn = flash_attention.cost(B, S, past + S, Hq, Hkv, D)["flops"]
    return 2.0 * B * S * products + attn


def state_bytes(c: dict, B: int, S: int, past: int) -> float:
    d = dense.dims(c)
    return 2.0 * B * (past + S) * d["Hkv"] * d["D"] * 2
