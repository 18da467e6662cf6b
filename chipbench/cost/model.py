"""A whole step's model FLOPs and bytes, and its least time on the
published peaks: every layer by its kind's cost module
(``chipbench/cost/<kind>.py``), the output head on the rows that get
logits, the weights read once (the served dtypes of the reference's
tables: matrices bfloat16, vectors float32; of the embedding only the rows
looked up) and each layer's cache or state."""
from __future__ import annotations

import importlib

from chipbench.cost import peaks
from chipbench.reference import model as ref_model


def _kind(kind: str):
    return importlib.import_module(f"chipbench.cost.{kind}")


def _nbytes(table: dict) -> int:
    total = 0
    for shape, dtype, _ in table.values():
        n = 1
        for s in shape:
            n *= s
        total += n * (2 if dtype == "bfloat16" else 4)
    return total


def step(c: dict, B: int, S: int, past: int = 0, logit_rows: int = 0) -> dict:
    """B rows of S new tokens after ``past`` cached ones; ``logit_rows``
    positions get logits (B for a prefill's last tokens or a decode step).
    -> {"flops", "bytes"}."""
    M, V = c["hidden_size"], c["vocab_size"]
    flops = 2.0 * M * V * logit_rows
    nbytes = 2.0 * M * V + 2.0 * M * B * S + 4.0 * M   # head, embedded rows, final norm
    for kind in ref_model.layer_kinds(c):
        mod = _kind(kind)
        flops += mod.flops(c, B, S, past)
        nbytes += _nbytes(ref_model.block(kind).weights(c)) + mod.state_bytes(c, B, S, past)
    return {"flops": flops, "bytes": nbytes}


def least_seconds(c: dict, B: int, S: int, past: int = 0, logit_rows: int = 0) -> float:
    s = step(c, B, S, past, logit_rows)
    return peaks.least_seconds(flops=s["flops"], nbytes=s["bytes"])
