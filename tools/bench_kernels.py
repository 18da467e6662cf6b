#!/usr/bin/env python3
"""Time the selective-scan and pack kernels on one GPU, at the shapes the
port's paths give them.

    python3 tools/bench_kernels.py [--src DIR] [--reps N] [--kernels scan,pack]

``--src`` names the ``src`` directory whose ``repro_torch`` kernels are
built and timed (default: this checkout's), so that two versions can be
timed in one call on one card, in turns (old, new, new, old). Each kernel
is checked against its plain version on the timed input first: the scan's
y and h_last must equal the plain result in every element, the pack's
blocks and scales byte for byte. Shapes:
  * scan: falcon-mamba-7b's prefill, B=4 S=4600 di=8192 N=16; x, B, C
    bf16 and dt f32, B and C column slices of one (B, S, 256 + 2N) buffer,
    as the model's x_proj output gives them;
  * pack: the paper's 201x501x501 mesh as int8 codec blocks of 4096, the
    seismic field at step 7 (6.7% of its values subnormal) and normal
    values.
Prints the card (name, power limit) and, as its last line, a JSON object of
times in ms (CUDA events over ``--reps`` launches after a warm-up).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SCAN_SHAPE = dict(B=4, S=4600, di=8192, N=16, dt_rank=256)
MESH = dict(nx=201, ny=501, nz=501)
BLOCK = 4096


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="scan,pack",
                    help="comma-separated: which of scan, pack to time")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_kernels: needs a GPU (torch.cuda.is_available() is false)")
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.kernels.staging_pack import ops as pack_ops
    from repro_torch.kernels.staging_pack.ref import pack_blocks_ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def time_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    out = {"src": args.src}
    kernels = set(args.kernels.split(","))
    if "scan" in kernels:
        scan(out, randn, time_ms, scan_ops.selective_scan, ssm_scan_ref)
        torch.cuda.empty_cache()
    if "pack" in kernels:
        pack(out, randn, time_ms, pack_ops.quantize_blocks, pack_blocks_ref, dev)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    if not all(v for k, v in out.items() if k.endswith("_equal")):
        sys.exit("bench_kernels: a kernel disagrees with its plain version")


def scan(out, randn, time_ms, selective_scan, ssm_scan_ref) -> None:
    import torch
    s = SCAN_SHAPE
    B, S, di, N, R = s["B"], s["S"], s["di"], s["N"], s["dt_rank"]
    xi = randn(B, S, di).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(randn(B, S, di)) * 0.1
    bc = randn(B, S, R + 2 * N).to(torch.bfloat16)
    inputs = (xi, dt, bc[..., R:R + N], bc[..., R + N:],
              -torch.exp(randn(di, N) * 0.2), randn(B, di, N))
    y, h = selective_scan(*inputs)
    y_p, h_p = ssm_scan_ref(*inputs)
    out["scan_equal"] = bool(torch.equal(y, y_p) and torch.equal(h, h_p))
    del y, h, y_p, h_p
    out["scan_ms"] = time_ms(lambda: selective_scan(*inputs))


def pack(out, randn, time_ms, quantize_blocks, pack_blocks_ref, dev) -> None:
    import torch
    from repro_torch.data.seismic import SeismicConfig, SeismicField
    n = MESH["nx"] * MESH["ny"] * MESH["nz"]
    nb = -(-n // BLOCK)
    fields = {"seismic": SeismicField(SeismicConfig(**MESH), device=dev).step(7).float(),
              "normal": randn(n)}
    for name, x in fields.items():
        q, sc = quantize_blocks(x, block_elems=BLOCK)
        xp = torch.nn.functional.pad(x.reshape(-1), (0, nb * BLOCK - n))
        q_p, s_p = pack_blocks_ref(xp.reshape(-1, 128), tile=(BLOCK // 128, 128),
                                   out_dtype=torch.int8)
        out[f"pack_{name}_equal"] = bool(torch.equal(q, q_p) and torch.equal(sc, s_p))
        out[f"pack_{name}_ms"] = time_ms(
            lambda x=x: quantize_blocks(x, block_elems=BLOCK))


if __name__ == "__main__":
    main()
