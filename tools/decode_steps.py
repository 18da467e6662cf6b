#!/usr/bin/env python3
"""The batch-decode cell's steps, window by window: what spreads its rate
and its tail between runs.

    python3 tools/decode_steps.py --seed <n> [--windows 2] [--seconds 30] [--out FILE]

Sets ``qwen2-72b.batch-decode`` up as ``chipbench/run.py`` does, then runs
``--windows`` untraced windows of ``--seconds`` in this one process (two
windows of one seed tell a seed's effect from the host's). For each window
it reads the harness's rate, p95 gap and enqueue, and from the loop's own
records: the quartiles of the gap between steps that refill nothing and of
the host's enqueue, the refills and their gaps, the steps over 1.2 times
the median gap, the median gap in each tenth of the window, and the
process's CPU time over the window's wall time. Prints one JSON object a
window; with ``--out`` writes them all there. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
CELL = "qwen2-72b.batch-decode"


def quartiles(xs: list[float]) -> list[float]:
    q = statistics.quantiles(xs, n=4)
    return [round(q[0], 3), round(statistics.median(xs), 3), round(q[2], 3)]


def read_window(records: dict, metrics: dict, cpu_s: float, wall_s: float) -> dict:
    steps = [s for s in records["steps"] if s["in_window"]]
    te = [records["prev_te"]] + [s["te"] for s in steps]
    gaps = [(b - a) * 1e3 for a, b in zip(te, te[1:])]
    plain = [g for g, s in zip(gaps, steps) if not s["refill"]]
    med = statistics.median(plain)
    n = len(plain)
    return {**metrics, "steps": len(steps),
            "gap_ms_quartiles": quartiles(plain),
            "enqueue_ms_quartiles": quartiles([(s["tq"] - s["ts"]) * 1e3 for s in steps]),
            "refill_gaps_ms": [round(g, 2) for g, s in zip(gaps, steps) if s["refill"]],
            "steps_over_1.2x_median": sum(g > 1.2 * med for g in plain),
            "gap_ms_median_by_tenth": [
                round(statistics.median(plain[i * n // 10:(i + 1) * n // 10]), 3)
                for i in range(10)],
            "cpu_over_wall": cpu_s / wall_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    import torch

    from chipbench import harness
    cl = harness.prepare(CELL, args.seed, torch.device("cuda", 0), ROOT)
    setup_s = time.perf_counter() - T_START
    out = []
    for _ in range(args.windows):
        c0, t0 = time.process_time(), time.perf_counter()
        records, _ = harness.window(cl, args.seconds, False)
        cpu_s, wall_s = time.process_time() - c0, time.perf_counter() - t0
        ctx = harness.Context(cl.run.config, cl.run.workload, records, setup_s, None)
        metrics = {name: harness.reader(ROOT, name).read(ctx) for name in
                   ("decode_tokens_per_s", "itl_ms_p95", "host_enqueue_ms.decode")}
        out.append({"seed": args.seed, **read_window(records, metrics, cpu_s, wall_s)})
        print(json.dumps(out[-1]), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
