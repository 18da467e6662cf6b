#!/usr/bin/env python3
"""One benchmark cell's window, read by the program's layers.

    python3 tools/trace_spans.py --workload <cell> --seed <n> [--seconds 30]

Sets the cell up as ``chipbench/run.py`` does, then runs two windows of
``--seconds``: one the profiler does not record, then one it records. For
each it reads every metric reader under ``chipbench/metrics/`` that finds
something to read (so the host's rates and enqueue times untraced and
traced, and the trace's per-layer metrics, those of the program's spans
included); for the traced one also the device's busy and window seconds,
the operations with most device time, and the device time, the idle time
and the host's own time under each of the program's spans
(``chipbench.spans``). Prints one JSON object; with ``--out`` writes it
there too. Needs a CUDA card; ``trace_cell`` also runs on the CPU at the
tests' smoke sizes (no device time there).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _read_all(root: Path, ctx) -> dict:
    from chipbench import harness
    out = {}
    for path in sorted((root / "chipbench" / "metrics").glob("*.py")):
        value = harness.reader(root, path.stem).read(ctx)
        if value is not None:
            out[path.stem] = value
    return out


def trace_cell(cell: str, seed: int, seconds: float, device, root: Path = ROOT,
               **kw) -> dict:
    """The two windows of one cell (``kw``: ``harness.prepare``'s stand-ins
    for the cell's files and the clock; ``setup_s`` here is the cell's
    set-up alone, from ``harness.prepare``)."""
    import torch

    from chipbench import harness, spans, tracing

    t_start = time.perf_counter()
    cl = harness.prepare(cell, seed, device, root, **kw)
    setup_s = time.perf_counter() - t_start
    plain, _ = harness.window(cl, seconds, False)
    tr = tracing.Trace(True, cl.run.device)
    with torch.inference_mode():
        records = cl.loop.window(cl.run, cl.state, seconds, tr)
        cl.run.sync()
    summary = tr.summary()
    by_span = spans.read(tr.prof)
    c, w = cl.run.config, cl.run.workload
    untraced = _read_all(root, harness.Context(c, w, plain, setup_s, None))
    traced = _read_all(root, harness.Context(c, w, records, setup_s,
                                             {**summary, **by_span}))
    top = tracing.breakdown(summary)["device_ops"]
    n = len(records.get("steps") or records.get("calls"))
    return {"cell": cell, "seed": seed, "seconds": seconds, "device": str(device),
            "untraced": untraced, "traced": traced, "traced_steps_or_calls": n,
            "busy_s": summary["busy_s"], "window_s": summary["window_s"],
            "device_ops": top, **by_span}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    if not torch.cuda.is_available():
        print("tools/trace_spans.py needs a CUDA card", file=sys.stderr)
        return 2
    out = trace_cell(args.workload, args.seed, args.seconds, torch.device("cuda", 0))
    out["card"] = torch.cuda.get_device_name(0)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
