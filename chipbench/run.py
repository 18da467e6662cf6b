"""Run one cell of the benchmark once, on the card this process is started on.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the program is ``src/repro_torch``; its
CUDA kernels build into ``build/kernels/`` there on the first run and are
loaded from it after. The last line of standard output is the result's
JSON object; the last lines of standard error are each compared number
beside its limit. Exits non-zero, with no result, without enough CUDA
cards, when the program cannot be imported (a directory that holds only the
benchmark), or when the JAX stack or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"chipbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"chipbench: {args.workload} needs {chips} CUDA card(s); this "
              f"machine has {cards}", file=sys.stderr)
        return 2

    # the script's own directory is no package root; the checkout's is
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "chipbench"]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chipbench: the program is not in this checkout ({e})", file=sys.stderr)
        return 2
    from chipbench import harness

    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), torch.device("cuda", 0),
                                     T_START, root=ROOT)
    bad = harness.forbidden_modules()
    if bad:
        print(f"chipbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
