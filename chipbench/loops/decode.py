"""Lockstep batch decode at a steady mix of context lengths: ``sessions``
rows in ``groups`` equal groups, each row one session of a
``prompt_len``-token prompt and a ``max_new``-token answer, decoded
greedily into caches of ``max_len`` slots, one step for all rows at a
time, each step's tokens fed back and brought to the host (a step ends
when they reach it).

Set-up puts the groups at staggered points of their answers, as a server
that has run a while holds them: group g has (g + 1/2) * max_new / groups
answer tokens already, drawn from the seed and teacher-forced with its
prompt in one ``prefill_fn`` call, so the window's contexts spread evenly
over the answer's length. When a group's sessions have their whole
answer, the next step first prefills new prompts into its rows (their
first tokens count with the step's) and the other rows wait for it.
Set-up also runs one such refill and ``warm_steps`` steps, whose tokens
are served too.

Records: each step's host times (start, the return of ``decode_fn``
before any wait, the tokens on the host), the mean position it fed, the
rows it refilled, the tokens it brought, and whether they reached the host
inside the window."""
from __future__ import annotations

import numpy as np
import torch

from chipbench.tracing import span

SESSIONS, FORCED, WARM = 2, 3, 4    # the seed's streams of token ids


def _put_rows(big, small, r0: int) -> None:
    """Copy each leaf of a group's cache into rows r0.. of the whole
    batch's (the batch dimension is the one whose size differs)."""
    if isinstance(big, dict):
        for k in big:
            _put_rows(big[k], small[k], r0)
    elif isinstance(big, (list, tuple)):
        for b, s in zip(big, small):
            _put_rows(b, s, r0)
    else:
        dim = next(i for i, (a, b) in enumerate(zip(big.shape, small.shape)) if a != b)
        big.narrow(dim, r0, small.shape[dim]).copy_(small)


def _start(run, st: dict, g: int, tokens: np.ndarray) -> None:
    """A new session in each row of group g over ``tokens`` (its prompt
    and any forced answer): prefill, the rows of the cache, the first
    tokens to the host."""
    Bg = run.workload["sessions"] // run.workload["groups"]
    rows = slice(g * Bg, (g + 1) * Bg)
    logits, cache = st["prefill"](run.params, {
        "tokens": torch.from_numpy(tokens).to(run.device)})
    _put_rows(st["cache"], cache, g * Bg)
    del cache
    first = logits.argmax(-1, keepdim=True)
    st["tok"][rows] = first
    st["pos"][rows] = tokens.shape[1]
    st["live"][g] = {"prompt": tokens, "answered": tokens.shape[1] - run.workload["prompt_len"],
                     "served": [first.cpu().numpy()[:, 0]]}


def _refill(run, st: dict, g: int) -> None:
    w = run.workload
    st["done"][g].append(st["live"][g])
    _start(run, st, g, run.prompt(SESSIONS, st["next"], w["sessions"] // w["groups"],
                                  w["prompt_len"]))
    st["next"] += 1


def _step(run, st: dict) -> dict:
    w = run.workload
    Bg = w["sessions"] // w["groups"]
    ts = run.clock()
    refill = [g for g, s in enumerate(st["live"])
              if s["answered"] + len(s["served"]) >= w["max_new"]]
    for g in refill:
        _refill(run, st, g)
    past = float(np.mean([w["prompt_len"] + s["answered"] + len(s["served"]) - 1
                          for s in st["live"]]))
    logits, st["cache"] = st["decode"](
        run.params, st["cache"], {"tokens": st["tok"], "pos": st["pos"]})
    tq = run.clock()
    tok = logits.argmax(-1, keepdim=True)
    host = tok.cpu().numpy()[:, 0].copy()   # on the CPU, .cpu() would share tok's
    te = run.clock()
    st["pos"] += 1
    st["tok"] = tok
    for g, s in enumerate(st["live"]):
        s["served"].append(host[g * Bg:(g + 1) * Bg])
    return {"ts": ts, "tq": tq, "te": te, "past": past, "refill": len(refill) * Bg,
            "tokens": host.shape[0] + len(refill) * Bg}


def setup(run) -> dict:
    w = run.workload
    B, G, P, T = w["sessions"], w["groups"], w["prompt_len"], w["max_len"]
    if B % G or P + w["max_new"] > T:
        raise ValueError(f"{G} groups of {B} sessions, {P} + {w['max_new']} "
                         f"tokens in {T} slots")
    Bg = B // G
    st = {"prefill": run.serve.prefill_fn(max_len=T), "decode": run.serve.decode_fn(),
          "cache": run.serve.model.init_cache(B, T, run.device),
          "tok": torch.zeros((B, 1), dtype=torch.int64, device=run.device),
          "pos": torch.zeros((B,), dtype=torch.int32, device=run.device),
          "live": [None] * G, "done": [[] for _ in range(G)], "next": 0}
    # the refill's shapes, warmed in group 0's rows before its session
    _start(run, st, 0, run.prompt(WARM, 0, Bg, P))
    for g in range(G):
        forced = round((g + 0.5) * w["max_new"] / G)
        _start(run, st, g, np.concatenate(
            [run.prompt(SESSIONS, st["next"], Bg, P), run.prompt(FORCED, g, Bg, forced)], 1))
        st["next"] += 1
    for _ in range(w["warm_steps"]):
        st["last_te"] = _step(run, st)["te"]
    run.sync()
    return st


def window(run, st: dict, seconds: float, trace) -> dict:
    steps = []
    with trace:
        t0 = run.clock()
        while True:
            with span("decode_step"):
                s = _step(run, st)
            s["in_window"] = s["te"] - t0 <= seconds
            steps.append(s)
            if s["te"] - t0 >= seconds:
                break
    prev_te, st["last_te"] = st["last_te"], steps[-1]["te"]
    return {"kind": "decode", "t0": t0, "seconds": seconds, "B": run.workload["sessions"],
            "prev_te": prev_te, "steps": steps,
            "attempted": sum(s["tokens"] for s in steps)}


def served(run, st: dict, records: dict, rng, n: int) -> list[dict]:
    """One row of each group, drawn from the seed (``n`` rows at the
    least), with every session that row served: so the sample holds every
    stretch of the answer's length, the longest contexts, and a refilled
    row's new session where the window had one. The caches are let go."""
    st["cache"] = None
    w = run.workload
    G, Bg = w["groups"], w["sessions"] // w["groups"]
    picks = [g * Bg + rng.randrange(Bg) for g in range(G)]
    rest = [r for r in range(w["sessions"]) if r not in picks]
    picks += rng.sample(rest, max(0, min(n, w["sessions"]) - G))
    items = []
    for r in sorted(picks):
        g, i = divmod(r, Bg)
        for s in st["done"][g] + [st["live"][g]]:
            items.append({"kind": "seq", "prompt": s["prompt"][i],
                          "served": np.stack(s["served"], 1)[i]})
    return items
