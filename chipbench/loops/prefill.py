"""Closed-loop prefill: one call at a time, each of ``batch`` rows of one
prompt length, the lengths cycling through ``prompt_lengths`` from the
window's start; each row's first token (greedy) brought to the host ends
its request. The seed sets the token ids alone, so every seed does the same
work. Set-up runs one call of each length (its prompts from another stream
of the seed), so nothing is first seen inside the window.

Records: each call's length, rows, host times around it (the prompt's copy
to the card, ``prefill_fn``, the argmax and the first tokens' copy to the
host) and whether its first tokens reached the host inside the window."""
from __future__ import annotations

import torch

from chipbench.tracing import span

PROMPTS, WARM = 0, 1     # the seed's streams of token ids


def _request(run, fn, toks_host):
    toks = torch.from_numpy(toks_host).to(run.device)
    logits, cache = fn(run.params, {"tokens": toks})
    del cache
    return logits, logits.argmax(-1).cpu()


def setup(run) -> dict:
    w = run.workload
    lengths = list(dict.fromkeys(w["prompt_lengths"]))
    fns = {L: run.serve.prefill_fn(max_len=L + w["new_tokens"]) for L in lengths}
    for k, L in enumerate(lengths):
        _request(run, fns[L], run.prompt(WARM, k, w["batch"], L))
    run.sync()
    return {"fns": fns}


def window(run, state: dict, seconds: float, trace) -> dict:
    w = run.workload
    lengths, B = w["prompt_lengths"], w["batch"]
    calls = []
    with trace:
        t0 = run.clock()
        i = 0
        while True:
            L = lengths[i % len(lengths)]
            with span("prompt"):
                toks = run.prompt(PROMPTS, i, B, L)
            with span("request"):
                ts = run.clock()
                logits, first = _request(run, state["fns"][L], toks)
                te = run.clock()
            calls.append({"L": L, "B": B, "ts": ts, "te": te,
                          "in_window": te - t0 <= seconds, "tokens": toks,
                          "first": first.numpy(), "logits": logits})
            i += 1
            if te - t0 >= seconds:
                break
    return {"kind": "prefill", "t0": t0, "seconds": seconds, "calls": calls,
            "attempted": sum(c["B"] for c in calls)}


def served(run, state: dict, records: dict, rng, n: int) -> list[dict]:
    """``n`` requests (rows) drawn from the seed, with one of each prompt
    length the window served among them, the longest first; the calls'
    logits are let go."""
    calls = records["calls"]
    reqs = [(ci, r) for ci, c in enumerate(calls) for r in range(c["B"])]
    pick = [rng.choice([q for q in reqs if calls[q[0]]["L"] == L])
            for L in sorted({c["L"] for c in calls}, reverse=True)]
    rest = [q for q in reqs if q not in pick]
    pick += rng.sample(rest, max(0, min(n - len(pick), len(rest))))
    items = [{"kind": "last", "tokens": calls[ci]["tokens"][r],
              "served": int(calls[ci]["first"][r]),
              "logits": calls[ci]["logits"][r]} for ci, r in pick]
    for c in calls:
        c.pop("logits")
    return items
