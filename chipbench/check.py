"""Whether what the timed path served is right: the plain reference is run
over a sample of the window's requests, once the window has closed, and
the program's outputs are judged against it.

Two kinds of served output:
  * ``last``: a prompt, the first token the program served for it and the
    program's logits at the prompt's last position;
  * ``seq``: a session's prompt (with any answer forced before it was
    served) and every token the program served it, in order (each decode
    step's token fed back); one session at a time, so they may differ in
    length.

The numbers (each compared with its limit in the workload file):
  * ``token_gap``: the widest gap, over the served tokens, by which a
    served token's reference logit lies below the reference's best at that
    position (0 where the program served the reference's choice);
  * ``logit_rel_err``: over the ``last`` items, the widest
    ||program - reference|| / ||reference|| of the logits at the last
    position.

The control (``control=True``) puts the reference in fp8
(``reference.precision.FP8``) in the program's place: its own logits and
its own first choice at each position are judged the same way.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from chipbench.reference import precision
from chipbench.reference.model import Reference

HEAD_ROWS = 256      # positions a block of the reference's head


def _gap(logits: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    return logits.max(-1).values - logits.gather(-1, picked[..., None])[..., 0]


def numbers(c: dict, weights: dict, items: list[dict], device,
            control: bool = False) -> dict:
    ref = Reference(c, weights, "float32")
    ctl = Reference(c, weights, "fp8") if control else None
    gaps, rel = [], []
    with precision.exact(), torch.inference_mode():
        for it in (i for i in items if i["kind"] == "last"):
            toks = torch.as_tensor(it["tokens"], device=device)[None]
            want = ref.logits(ref.hidden(toks)[:, -1])[0]
            if control:
                got = ctl.logits(ctl.hidden(toks)[:, -1])[0]
                pick = got.argmax()
            else:
                got = it["logits"].float().to(device)
                pick = torch.tensor(it["served"], device=device)
            gaps.append(float(_gap(want[None], pick.reshape(1))[0]))
            rel.append(float(torch.linalg.vector_norm(got - want)
                             / torch.linalg.vector_norm(want)))
        for it in (i for i in items if i["kind"] == "seq"):
            P = len(it["prompt"])
            served = torch.as_tensor(it["served"], device=device)
            toks = torch.cat([torch.as_tensor(it["prompt"], device=device),
                              served[:-1]])[None]
            h = ref.hidden(toks)[0, P - 1:]
            hc = ctl.hidden(toks)[0, P - 1:] if control else None
            for r0 in range(0, h.shape[0], HEAD_ROWS):
                lg = ref.logits(h[r0:r0 + HEAD_ROWS])
                pick = (ctl.logits(hc[r0:r0 + HEAD_ROWS]).argmax(-1) if control
                        else served[r0:r0 + HEAD_ROWS])
                gaps.extend(_gap(lg, pick).tolist())
    out = {"token_gap": max(gaps), "n_tokens": len(gaps)}
    if rel:
        out["logit_rel_err"] = max(rel)
    return out


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for each limited number; a
    number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = found.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks
