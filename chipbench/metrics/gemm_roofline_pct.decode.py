"""The weight GEMMs' share of their roofline in the traced decode window:
for each step, the least time of its products with weight matrices
(``chipbench.cost.gemm``: every row's token through every layer's
matrices and the head; the matrices read once), and a refill's prefill
as a pass of its own (its rows' prompts, the head on their last tokens),
summed over the steps the trace holds, over the device time of the
operations launched inside the program's ``repro_torch.gemm`` spans."""
from chipbench.cost import gemm

SPAN = "repro_torch.gemm"


def read(ctx):
    t, r = ctx.trace, ctx.records
    if t is None or r["kind"] != "decode" or not r["steps"]:
        return None
    busy = t.get("device_by_span", {}).get(SPAN, 0.0)
    if busy <= 0:
        return None
    B, P = r["B"], ctx.workload["prompt_len"]
    least = sum(gemm.least_seconds(ctx.config, B, 1, B)
                + (gemm.least_seconds(ctx.config, s["refill"], P, s["refill"])
                   if s["refill"] else 0.0)
                for s in r["steps"])
    return 100.0 * least / busy
