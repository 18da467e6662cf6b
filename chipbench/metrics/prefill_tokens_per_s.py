"""Prompt tokens of the requests whose first token reached the host inside
the window, over the time from the window's start to the last of those
first tokens. A request cut by the window's end neither counts nor is
charged."""


def read(ctx):
    r = ctx.records
    if r["kind"] != "prefill":
        return None
    done = [c for c in r["calls"] if c["in_window"]]
    if not done:
        return None
    return sum(c["L"] * c["B"] for c in done) / (max(c["te"] for c in done) - r["t0"])
