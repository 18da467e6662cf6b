"""The median over the window's decode steps that refill no rows of the
host's time from a step's start to the return of ``decode_fn`` (the
launches enqueued, before any wait on the card): the benchmark's own host
clock around the call, in a window the profiler does not record."""
import statistics


def read(ctx):
    r = ctx.records
    if r is None or r["kind"] != "decode":
        return None
    spans = [(s["tq"] - s["ts"]) * 1e3 for s in r["steps"]
             if s["in_window"] and not s["refill"]]
    return statistics.median(spans) if spans else None
