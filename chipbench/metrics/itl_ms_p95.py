"""The 95th percentile, over every step of the window, of the gap between
a step's tokens reaching the host and the previous step's (the first
step's previous is set-up's last)."""
from chipbench.stats import percentile


def read(ctx):
    r = ctx.records
    if r["kind"] != "decode":
        return None
    te = [r["prev_te"]] + [s["te"] for s in r["steps"] if s["in_window"]]
    if len(te) < 2:
        return None
    return percentile([(b - a) * 1e3 for a, b in zip(te, te[1:])], 95)
