"""The readings the check's limits are set from, on the card at a cell's
own size: for each seed, the program's numbers (a run's set-up and a
window long enough to serve the cell's longest request, then the check's
sample against the float32 reference) and, on the control's seeds, the
control's numbers on the same sample (the reference in fp8 in the
program's place). One process for all the seeds.

    python3 chipbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--seconds 4]

Prints one JSON line a seed: {"seed", "program": {...}, "control": {...}}.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell: str, seed: int, seconds: float, control: bool, device) -> dict:
    """One seed's numbers: the program's and, with ``control``, the
    control's, on the same served sample."""
    from chipbench import check, harness

    cl = harness.prepare(cell, seed, device, ROOT)
    records, _ = harness.window(cl, seconds, trace=False)
    items = harness.served(cl, records)
    c, raw = cl.run.config, cl.run.weights
    out = {"seed": seed, "program": check.numbers(c, raw, items, device)}
    if control:
        out["control"] = check.numbers(c, raw, items, device, control=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="the window; default the workload's control_seconds")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "chipbench"]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # one process holds many seeds' set-ups and references in turn
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chipbench/control.py needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from chipbench import harness
    seconds = args.seconds or harness.workload_file(ROOT, args.workload)["check"]["control_seconds"]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(args.workload, s, seconds, s in ctl, dev)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
