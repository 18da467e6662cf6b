"""The least time of a call's products with weight matrices: every layer's
matrices (the reference's weight tables, ``chipbench/reference/<kind>.py``,
the weights that enter a product) and the output head. Two operations a
multiply-add for each token a matrix sees, the head on the rows that get
logits, over the bf16 peak; every matrix read once in bfloat16 (the head
too), over the HBM rate."""
from __future__ import annotations

import math

from chipbench.cost import peaks
from chipbench.reference import model as ref_model


def layer_matrix_params(c: dict, kind: str) -> int:
    """The parameters of one layer's weight matrices."""
    return sum(math.prod(shape) for name, (shape, _, _)
               in ref_model.block(kind).weights(c).items() if ref_model.is_product(name))


def cost(c: dict, B: int, S: int, logit_rows: int) -> dict:
    """B rows of S tokens through every layer's matrices; ``logit_rows``
    rows through the head. -> {"flops", "bytes"}."""
    head = c["hidden_size"] * c["vocab_size"]
    params = sum(layer_matrix_params(c, k) for k in ref_model.layer_kinds(c))
    return {"flops": 2.0 * B * S * params + 2.0 * head * logit_rows,
            "bytes": 2.0 * (params + head)}


def least_seconds(c: dict, B: int, S: int, logit_rows: int) -> float:
    x = cost(c, B, S, logit_rows)
    return peaks.least_seconds(flops=x["flops"], nbytes=x["bytes"])
