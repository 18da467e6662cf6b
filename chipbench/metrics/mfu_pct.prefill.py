"""The traced prefill window's share of its roofline on the published
peaks: for each call, the larger of its model FLOPs over the bf16 peak and
the bytes it needs over the HBM rate (``chipbench.cost.model``: two
operations a parameter a token passes through, causal attention from the
shapes, the head on each row's last token; the weights once and the cache
once, in their served dtypes), summed over the calls the trace holds and
divided by the traced window."""
from chipbench.cost import model


def read(ctx):
    t, r = ctx.trace, ctx.records
    if t is None or r["kind"] != "prefill" or not r["calls"]:
        return None
    least = sum(model.least_seconds(ctx.config, c["B"], c["L"], 0, c["B"])
                for c in r["calls"])
    return 100.0 * least / t["window_s"]
