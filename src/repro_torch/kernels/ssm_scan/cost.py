"""The selective scan's cost by the kernel's own formula: B·S·di·N
exponentials (one a state update), 6 fp32 operations a state update (dt·A,
decay·h, dx·B_t, h·C_t) plus dt·x a channel, and every input read once
and every output written once. ``chip_smoke.py``'s bound and the op
counter of the dry run (``launch.op_analysis``) both read it."""
from __future__ import annotations


def scan_cost(inputs, outputs) -> dict:
    """inputs (xi, dt, Bm, Cm, A, h0) and outputs (y, h_last), tensors or
    meta tensors -> {"flops", "exps", "bytes"}."""
    xi, A = inputs[0], inputs[4]
    B, S, di = xi.shape
    N = A.shape[1]
    return {"flops": B * S * di * (6 * N + 1), "exps": B * S * di * N,
            "bytes": sum(t.numel() * t.element_size()
                         for t in (*inputs, *outputs))}
