#!/usr/bin/env python3
"""Where the time goes on the port's serve paths, on one GPU.

    python3 tools/profile_serve.py

Serves each cell that ``chip_smoke.py`` serves (``chip_smoke.CELLS``:
gemma2-27b at published widths with its depth cut to 4 layers, then
falcon-mamba-7b at published widths and full depth; 4 prompts of 4600
tokens, 32 greedy tokens) through ``repro_torch.launch.serve.serve``: once
to warm up, then once more with torch.profiler tracing the prefill and the
decode loop apart. For each cell and phase it prints the wall time, the
summed device time of the kernels, the number of kernel launches, the
device's idle share (1 - kernel time / wall time; kernels run on one
stream) and the kernels with the most device time. The last line is a
JSON summary.
"""
from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOP = 12   # kernels listed per phase


def kernel_table(prof, torch) -> tuple[float, int, list[dict]]:
    """(total device ms, kernel launches, the TOP kernels) from a finished
    profile."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append({"kernel": e.key[:90], "calls": e.count, "ms": us / 1e3})
    rows.sort(key=lambda r: -r["ms"])
    return (sum(r["ms"] for r in rows), sum(r["calls"] for r in rows),
            rows[:TOP])


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import CELLS, card_line, cell_config
    from repro_torch.launch.serve import serve

    if not torch.cuda.is_available():
        sys.exit("tools/profile_serve.py needs a GPU")
    card = card_line()
    dev = torch.device("cuda", 0)
    def profile_cell(cell) -> dict:
        cfg = cell_config(cell)
        kw = dict(batch=cell["batch"], prompt_len=cell["prompt_len"],
                  new_tokens=cell["new_tokens"], seed=cell["seed"], device=dev)
        profiles = {}

        @contextlib.contextmanager
        def traced(name):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                yield
            profiles[name] = prof

        warm = serve(cfg, **kw)
        run = serve(cfg, **kw, params=warm["params"], prompts=warm["prompts"],
                    phase=traced)
        del warm
        out = {"config": f"{cfg.name} n_layers={cfg.n_layers}",
               **{k: cell[k] for k in ("batch", "prompt_len", "new_tokens")}}
        for phase, wall_ms, per in (("prefill", run["prefill_ms"], 1),
                                    ("decode", sum(run["decode_ms"]),
                                     len(run["decode_ms"]))):
            busy_ms, launches, top = kernel_table(profiles[phase], torch)
            out[phase] = {
                "wall_ms": wall_ms / per, "device_ms": busy_ms / per,
                "kernel_launches": launches / per,
                "idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
                "top_kernels": top}
            print(f"[profile] {cfg.name} {phase}: wall {wall_ms / per:.3f} ms, "
                  f"device {busy_ms / per:.3f} ms, {launches / per:.0f} kernel "
                  f"launches per {'step' if per > 1 else 'call'}; idle share "
                  f"{out[phase]['idle_share']}")
            for r in top:
                print(f"[profile]   {r['ms'] / per:9.3f} ms  "
                      f"x{r['calls'] // per:<4} {r['kernel']}")
        return out

    summary = {"card": card}
    for cell in CELLS:
        summary[cell["arch"]] = profile_cell(cell)
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
