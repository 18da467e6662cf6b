"""The selective scan's work from its shapes: one exponential a state
update (B * S * di * N, at the SFU's rate), six float32 operations a
state update (dt A, the decay times h, dt x times B, h times C) plus dt x
a channel, and the bytes of the inputs read once and the outputs written
once: x, B, C and y in bfloat16, dt in float32 (its bias is float32), A
and the first and last states in float32."""
from __future__ import annotations

from chipbench.cost import peaks


def cost(B: int, S: int, di: int, N: int) -> dict:
    bf16, f32 = 2, 4
    nbytes = (B * S * di * (bf16 + f32 + bf16)      # x, dt in; y out
              + 2 * B * S * N * bf16                 # B, C
              + di * N * f32 + 2 * B * di * N * f32)  # A, h0, h_last
    return {"exps": B * S * di * N, "f32_flops": B * S * di * (6 * N + 1),
            "bytes": nbytes}


def least_seconds(B: int, S: int, di: int, N: int) -> float:
    c = cost(B, S, di, N)
    return peaks.least_seconds(nbytes=c["bytes"], exps=c["exps"],
                               f32_flops=c["f32_flops"])
