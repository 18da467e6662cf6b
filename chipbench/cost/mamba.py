"""A Mamba-1 layer's model FLOPs and state bytes: the four projections,
two operations a multiply-add, the depthwise convolution, and the scan's
float32 arithmetic (six operations a state update and one a channel); the
convolution's carry (bfloat16) and the float32 state written once a row."""
from __future__ import annotations

from chipbench.reference import mamba


def flops(c: dict, B: int, S: int, past: int) -> float:
    d = mamba.dims(c)
    M, di, N, K, R = d["M"], d["di"], d["N"], d["K"], d["R"]
    products = M * 2 * di + di * (R + 2 * N) + R * di + di * M
    return B * S * (2.0 * products + 2 * K * di + di * (6 * N + 1))


def state_bytes(c: dict, B: int, S: int, past: int) -> float:
    d = mamba.dims(c)
    return B * ((d["K"] - 1) * d["di"] * 2 + d["di"] * d["N"] * 4)
