"""Tokens that reached the host inside the window (a refill's first tokens
with its step's), over the time from the window's start to the last of
them."""


def read(ctx):
    r = ctx.records
    if r["kind"] != "decode":
        return None
    done = [s for s in r["steps"] if s["in_window"]]
    if not done:
        return None
    return sum(s["tokens"] for s in done) / (done[-1]["te"] - r["t0"])
