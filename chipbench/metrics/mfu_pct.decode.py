"""The traced decode window's share of its roofline on the published
peaks: for each step, the larger of its model FLOPs over the bf16 peak and
the bytes it needs over the HBM rate (``chipbench.cost.model``: the
weights once, each row's KV cache up to its position once, taken at the
rows' mean position, which both counts are linear in; a refill's prefill
as a prefill), summed over the steps the trace holds and divided by the
traced window."""
from chipbench.cost import model


def read(ctx):
    t, r = ctx.trace, ctx.records
    if t is None or r["kind"] != "decode" or not r["steps"]:
        return None
    B, P = r["B"], ctx.workload["prompt_len"]
    least = sum(model.least_seconds(ctx.config, B, 1, s["past"], B)
                + (model.least_seconds(ctx.config, s["refill"], P, 0, s["refill"])
                   if s["refill"] else 0.0)
                for s in r["steps"])
    return 100.0 * least / t["window_s"]
