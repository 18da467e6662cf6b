#!/usr/bin/env python3
"""falcon-mamba's training gradients on the card through the selective-scan
kernel, against the same step through the plain scan.

    python3 tools/scan_grads.py [--src DIR]

Takes falcon-mamba's smoke config in f32 at ``chip_smoke.TP_CHECK``'s seeded
state and batch (B 4, S 64), computes one step's gradients on one device
twice (the kernel path, then with the plain scan in its place) and prints
one JSON line: each leaf's largest |g - g_plain| / max |g_plain|, whether
every leaf's bits are equal, and the kernel's launches. ``--src`` runs
another checkout's ``src/`` (unpack it with ``git archive <commit> src``);
a tree whose scan has no backward cannot give ``A_log``, ``dt_proj``,
``dt_bias`` and ``x_proj`` a gradient there: the error is printed and the
exit code is 1. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the checkout to run")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("no GPU: this tool runs on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = chip_smoke.mamba_grads_through_the_kernel(dev)
    except RuntimeError:
        print(json.dumps({"src": args.src, "gradients": "raised",
                          "raised": traceback.format_exc().strip().splitlines()[-1]}))
        return 1
    print(json.dumps({"src": args.src, "gradients": "taken", "card": chip_smoke.card_line(),
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
