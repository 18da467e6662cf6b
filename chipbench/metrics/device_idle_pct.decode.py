"""The share of the traced decode window in which no operation ran on the
card (kernels, copies and sets, their union), from the trace."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.records["kind"] != "decode" or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
