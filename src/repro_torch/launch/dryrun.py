"""Multi-pod dry run on the meta device: every (architecture x input shape)
cell on a production mesh, one rank's step traced with no storage and no
world, its ops, bytes, collectives and memory counted. The port's twin of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell, subprocesses

Where the reference lowers and compiles the step on an abstract mesh and
reads XLA's cost and memory analysis, the port runs the step once on
``device="meta"`` (``TrainSetup.abstract_state``, ``input_specs``,
``ServeSetup.abstract_cache``) on an ``AbstractMesh`` seen from rank 0,
under ``launch.op_analysis``: the hand-written kernels return their
outputs' shapes and note their own cost, and the collectives move nothing
and are noted by class. A trace time takes the place of lower and compile
times. ``--opts`` takes the reference's options: ``comm_remat`` (remat
"comm"), ``micro<N>``, ``padheads<N>``, ``bf16_params``, ``lowp``
(``models.layers.lowp_collectives``) and ``fsdp`` (``fsdp_experts``).
``--mesh`` also takes a debug size (``DxM``, ``PxDxM``).

Per-cell JSON lands in results/dryrun_torch/<arch>__<shape>__<mesh>.json,
never among the reference's results/dryrun/ files.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def parse_opts(cfg, opts: str):
    """(cfg, options) for ``--opts``: the config with ``comm_remat``,
    ``padheads<N>`` and ``bf16_params`` applied, and {"micro", "fsdp",
    "lowp"} for the step."""
    opt_set = {o for o in opts.split(",") if o}
    if "comm_remat" in opt_set:     # keep post-AR outputs; no backward re-AR
        cfg = dataclasses.replace(cfg, remat="comm")
    micro = 1
    for o in opt_set:
        if o.startswith("micro"):
            micro = int(o[5:])
        elif o.startswith("padheads"):
            cfg = dataclasses.replace(cfg, pad_heads_to=int(o[8:]))
    if "bf16_params" in opt_set:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    return cfg, {"micro": micro, "fsdp": "fsdp" in opt_set, "lowp": "lowp" in opt_set}


def build_step(cfg, shape, mesh=None, *, micro: int = 1, fsdp: bool = False,
               device="meta", seed: int = 0):
    """(fn, args) of one step of this (config, shape) on this rank of
    ``mesh`` (one device where None): the train step with its state and
    rows, or prefill or decode with params, caches and rows. On meta the
    state, caches and inputs are shapes alone (``abstract_state``,
    ``input_specs``, ``abstract_cache``); on a device they are the seeded
    init and random tokens (a full loss mask, decode at the last slot)."""
    import torch

    from repro_torch.configs import input_specs
    from repro_torch.models import Model
    from repro_torch.train.serve_step import ServeSetup
    from repro_torch.train.train_step import TrainConfig, TrainSetup

    B, S = shape.global_batch, shape.seq_len
    specs = input_specs(cfg, shape)
    meta = torch.device(device).type == "meta"
    if not meta:
        gen = torch.Generator().manual_seed(seed)
        specs = {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                                   dtype=v.dtype) if k in ("tokens", "targets")
                     else torch.full(v.shape, S - 1, dtype=v.dtype) if k == "pos"
                     else torch.ones(v.shape, dtype=v.dtype) if k == "loss_mask"
                     else torch.randn(v.shape, generator=gen).to(v.dtype) * 0.02)
                 .to(device) for k, v in specs.items()}
    if shape.kind == "train":
        setup = TrainSetup(Model(cfg), TrainConfig(microbatches=micro,
                                                   fsdp_experts=fsdp), mesh)
        state = setup.abstract_state() if meta else setup.init_state(seed, device)
        return setup.step_fn(), (state, setup.shard_batch(specs))
    setup = ServeSetup(Model(cfg), mesh, global_batch=B,
                       seq_shard_kv=(shape.kind == "decode" and S >= 100_000))
    rows = setup.rows(B)
    batch = {k: v[rows] for k, v in specs.items()}
    params = setup.abstract_params() if meta else setup.init_params(seed, device)
    if shape.kind == "prefill":
        return setup.prefill_fn(), (params, batch)
    cache = (setup.abstract_cache(B, S) if meta else
             setup.model.init_cache(B, S, device, mesh, setup.rules))
    return setup.decode_fn(), (params, cache, batch)


def count_step(cfg, shape, mesh=None, *, micro: int = 1, fsdp: bool = False,
               lowp: bool = False, by_op: bool = False) -> dict:
    """One step of the cell on meta (``build_step``) run once under
    ``launch.op_analysis``: its per-rank counts, with ``trace_s`` the
    seconds the step took."""
    from repro_torch.launch import op_analysis
    from repro_torch.models.layers import lowp_collectives

    fn, args = build_step(cfg, shape, mesh, micro=micro, fsdp=fsdp)
    t0 = time.time()
    with lowp_collectives(lowp):
        _, deep = op_analysis.analyze(fn, *args, by_op=by_op)
    deep["trace_s"] = time.time() - t0
    return deep


def run_cell(arch: str, shape_name: str, mesh_kind: str, opts: str = "") -> dict:
    """One cell's record (module docstring): ``status`` ``ok`` with its
    per-rank counts, or ``skipped`` with the reference's reason."""
    from repro_torch.configs import (SHAPES, flops_per_step, get_config,
                                     shape_applicable)
    from repro_torch.launch.mesh import abstract_mesh

    cfg, step_opts = parse_opts(get_config(arch), opts)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "when": time.strftime("%F %T")}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh = abstract_mesh(mesh_kind)
    deep = count_step(cfg, shape, mesh, **step_opts)
    rec.update(
        status="ok",
        n_chips=mesh.size,
        trace_s=round(deep["trace_s"], 2),
        flops=deep["flops"],
        vpu_flops=deep["vpu_flops"],
        hbm_bytes=deep["hbm_bytes"],
        model_flops=flops_per_step(cfg, shape),
        collectives={"bytes": deep["collective_bytes"],
                     "counts": deep["collective_counts"],
                     "total_bytes": deep["collective_total"]},
        memory={"argument_bytes": deep["argument_bytes"],
                "output_bytes": deep["output_bytes"],
                "peak_bytes": deep["peak_bytes"]},
        n_ops=deep["n_ops"],
        kernels=deep["kernels"],
    )
    return rec


def cell_path(arch: str, shape: str, mesh: str, tag: str = "",
              out: str = RESULTS_DIR) -> str:
    os.makedirs(out, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out, f"{arch}__{shape}__{mesh}{suffix}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    help="single (16x16), multi (2x16x16), DxM or PxDxM")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--opts", default="",
                    help="comm_remat,micro<N>,padheads<N>,bf16_params,lowp,fsdp")
    ap.add_argument("--tag", default="", help="variant suffix for the JSON")
    ap.add_argument("--out", default=RESULTS_DIR, help="directory of the JSONs")
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs import ARCH_IDS, SHAPES
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (SRC, os.environ.get("PYTHONPATH")) if p)}
        failures = 0
        for mesh in ("single", "multi"):
            for arch in ARCH_IDS:
                for shape in SHAPES:
                    p = cell_path(arch, shape, mesh, args.tag, args.out)
                    if os.path.exists(p) and not args.force:
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape, "--mesh", mesh,
                           "--opts", args.opts, "--tag", args.tag,
                           "--out", args.out, "--quiet"]
                    print(f"[dryrun] {arch} x {shape} x {mesh} ...", flush=True)
                    r = subprocess.run(cmd, capture_output=True, text=True, env=env)
                    if r.returncode != 0:
                        failures += 1
                        print(r.stdout[-2000:], r.stderr[-4000:], flush=True)
        print(f"[dryrun] sweep done, {failures} failures")
        return 1 if failures else 0

    try:
        rec = run_cell(args.arch, args.shape, args.mesh, opts=args.opts)
        rec["opts"] = args.opts
    except Exception as e:  # noqa: BLE001 -- recorded in the cell's JSON
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    with open(cell_path(args.arch, args.shape, args.mesh, args.tag, args.out),
              "w") as f:
        json.dump(rec, f, indent=1)
    if not args.quiet:
        print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                         indent=1))
    if rec.get("status") == "error":
        print(rec.get("traceback", ""), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
