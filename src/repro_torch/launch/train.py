"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Wires together: config registry -> model -> mesh -> TrainSetup (autograd,
AdamW with ZeRO-1, optional compressed cross-pod grads, in-step egress) ->
synthetic data pipeline -> fault-tolerant Supervisor (asynchronous
checkpoints through the staging path) -> in-transit sink (the paper's
consumer is a live SAVIME you can query while training). With ``--intransit`` each step's egress (its
diagnostics, and with ``--egress grads_int8`` the int8 gradient blocks and
their scales) is staged into SAVIME as the step ends, as
``examples/train_with_intransit.py`` stages it, and so is each checkpoint.

The port of ``repro/launch/train.py``, with ``--device`` (CUDA unless the
CPU is asked for). ``--mesh DxM`` or ``PxDxM`` runs one process a rank
(``launch.spawn``, gloo groups; on CUDA every rank on a card of the
machine, all on one when it has one), with tensor and expert parallelism
over M, and ``main`` returns rank 0's results; rank 0 alone runs the
in-transit sink, stages each step's egress and writes the checkpoints.
``--mesh single`` and ``multi`` need 256 and 512 ranks, as the reference's
do; a model axis that divides neither the heads nor ``pad_heads_to``
exits 2.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import analysis, transport
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import (DataConfig, SyntheticLM, batch_to_device,
                              device_put_batch)
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch.mesh import build_mesh, parse_mesh, rank_device
from repro_torch.launch.spawn import run_ranks
from repro_torch.models import Model
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.tensors import to_host
from repro_torch.train import TrainConfig, TrainSetup
from repro_torch.train import train_step as train_step_mod

# the names each step's egress is staged under
EGRESS_NAMES = {"diag": "diag", "blocks": "grad_blocks", "scales": "grad_scales"}


def stage_egress(sink, egress: dict, step: int) -> dict:
    """Stage a step's egress through the sink, each tensor copied to the
    host first (the step made them fresh; the copies are what the sink
    holds until acknowledged). Returns the host copies by staged name."""
    staged = {}
    for key, name in EGRESS_NAMES.items():
        if key in egress:
            staged[name] = to_host(egress[key])
            sink.stage_array(name, staged[name], step=step)
    return staged


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises when absent")
    ap.add_argument("--mesh", default="1x1",
                    help="single | multi | DxM | PxDxM (debug sizes): one "
                         "process a rank, tensor parallel over M")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--intransit", action="store_true",
                    help="stage per-step egress and checkpoints into SAVIME")
    ap.add_argument("--transport", default="rdma_staged",
                    choices=transport.available(),
                    help="egress engine for the in-transit sink")
    ap.add_argument("--channels", type=int, default=1,
                    help="stripe egress across N concurrent connections "
                         "with credit-based flow control (1 = off)")
    ap.add_argument("--wire-format", default="json",
                    choices=["json", "bin1"],
                    help="negotiate the struct-packed binary fast path "
                         "for hot data frames (falls back to json)")
    ap.add_argument("--coalesce-kb", type=int, default=0,
                    help="coalesce datasets below this size into jumbo "
                         "batched frames (KiB, 0 = off)")
    ap.add_argument("--page-kb", type=int, default=0,
                    help="run staging on the paged store with this page "
                         "size (KiB, 0 = flat regions); cold pages spill "
                         "to disk under memory pressure (DESIGN.md §11)")
    ap.add_argument("--spill-dir", default=None,
                    help="directory for spilled cold pages (default: a "
                         "spill/ subdir of the staging disk tier)")
    ap.add_argument("--dedup", action="store_true",
                    help="content-addressed page dedup: identical sealed "
                         "pages (e.g. repeated checkpoint shards) stored "
                         "once (needs --page-kb)")
    ap.add_argument("--codec", default="none",
                    help="egress reduction codec for staged datasets "
                         "(none | delta-rle | int8-block; DESIGN.md §13)")
    ap.add_argument("--decode-at", default="staging",
                    choices=["staging", "query"],
                    help="decode coded datasets at ingest (default) or "
                         "store them compressed and decode lazily on the "
                         "staging->SAVIME hop")
    ap.add_argument("--compress-pods", action="store_true",
                    help="int8 error-feedback cross-pod gradient reduction "
                         "(a mesh with more than one pod)")
    ap.add_argument("--egress", default="diag",
                    choices=["none", "diag", "grads_int8"])
    ap.add_argument("--faults", default=None,
                    help="seeded fault plan for the staging path — a DSL "
                         "string ('seed=42;drop:op=stripe,prob=0.01;"
                         "kill:target=staging:0,at_s=0.5') or a JSON plan "
                         "file; exercises retry/replay (DESIGN.md §15)")
    return ap


def train(args, log=print, mesh=None) -> dict:
    """Run the launcher's training, on one device or as this rank of
    ``mesh``. Returns the supervisor's metrics log, its restarts, the run's
    seconds and the kernels' launches in the run; with ``--intransit`` (on
    rank 0) also the staged diagnostics SAVIME holds (unless ``--egress
    none``), the session's transfer stats and the staging server's
    counters; on a mesh of more than one rank also every rank's launches
    and this rank's cross-pod wire bytes."""
    dev = rank_device(args.device)
    root = mesh is None or mesh.rank == 0
    if not root:
        def log(msg):
            return None
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = Model(cfg)
    log(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params on {dev}"
        + (f", mesh {mesh.shape}" if mesh is not None else ""))
    setup = TrainSetup(model, TrainConfig(
        peak_lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
        total_steps=args.steps, compress_pods=args.compress_pods,
        egress=args.egress), mesh)
    state = setup.init_state(0, dev)
    launches0, wire0 = dict(LAUNCHES), dict(train_step_mod.POD_WIRE)

    with contextlib.ExitStack() as stack:
        sink = savime = staging = None
        if args.intransit and root:
            from repro_torch.core import (InTransitConfig, InTransitSink,
                                          SavimeServer, StagingServer)
            savime = SavimeServer().start()
            stack.callback(savime.stop)
            staging = StagingServer(savime.addr,
                                    page_bytes=args.page_kb << 10,
                                    spill_dir=args.spill_dir,
                                    dedup=args.dedup).start()
            stack.callback(staging.stop)
            if args.faults:
                from repro_torch.faults import (FaultPlan, FaultScheduler,
                                                install, uninstall)
                plan = FaultPlan.parse(args.faults)
                install(plan, scope=[staging.addr, savime.addr])
                stack.callback(uninstall)
                stack.callback(FaultScheduler(plan, {
                    "staging:0": staging.stop,
                    "savime:0": savime.stop}).start().stop)
                log(f"[train] fault plan armed (seed={plan.seed}, "
                    f"{len(plan.rules)} rule(s))")
            # the staged path attaches to staging; copy-emulation transports
            # (scp_*, ssh_direct) reach SAVIME directly, as the baselines do
            sink_addr = (staging.addr if args.transport == "rdma_staged"
                         else savime.addr)
            sink = InTransitSink(sink_addr, InTransitConfig(
                io_threads=2, tar_prefix="train", transport=args.transport,
                n_channels=args.channels, wire_format=args.wire_format,
                coalesce_bytes=args.coalesce_kb << 10,
                page_bytes=args.page_kb << 10, spill_dir=args.spill_dir,
                dedup=args.dedup, codec=args.codec, decode_at=args.decode_at))
            stack.callback(sink.close)
            log(f"[train] in-transit sink --{args.transport}"
                f"(x{args.channels} channels, {args.wire_format} wire"
                f"{', coalescing' if args.coalesce_kb else ''}"
                f"{f', codec={args.codec}' if args.codec != 'none' else ''})"
                f"--> SAVIME {savime.addr}")
        ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro-torch-ckpt-")
        ckpt = CheckpointManager(ckpt_dir, sink=sink,
                                 layout=setup if mesh is not None else None)
        stack.callback(ckpt.close)
        step_fn = setup.step_fn()

        def step(state, batch):
            state, metrics, egress = step_fn(state, batch)
            if sink is not None:
                stage_egress(sink, egress, int(state["step"]))
            return state, metrics, egress

        sup = Supervisor(step, ckpt, SupervisorConfig(ckpt_every=args.ckpt_every))
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch)
        batches = (device_put_batch(b, mesh, setup.rules, dev,
                                    setup.cfg.microbatches) if mesh is not None
                   else batch_to_device(b, dev) for b in SyntheticLM(dc).batches())
        t0 = time.perf_counter()
        state = sup.run(state, batches, args.steps,
                        abstract_state=setup.state_specs(), device=dev)
        dt = time.perf_counter() - t0
        losses = [m["loss"] for m in sup.metrics_log]
        log(f"[train] {args.steps} steps in {dt:.1f}s "
            f"({dt / max(args.steps, 1) * 1e3:.0f} ms/step) "
            f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
            f"restarts={sup.restarts}; checkpoints in {ckpt_dir}")
        out = {"metrics": sup.metrics_log, "restarts": sup.restarts,
               "diag": None, "seconds": dt,
               "launches": {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES}}
        if mesh is not None and mesh.size > 1:
            out["pod_wire"] = {k: train_step_mod.POD_WIRE[k] - wire0[k]
                               for k in wire0}
            out["launches_by_rank"] = [None] * mesh.size
            dist.all_gather_object(out["launches_by_rank"], out["launches"])
        if sink is not None:
            sink.flush()
        if sink is not None and args.egress != "none":
            with analysis.AnalysisSession(savime.addr) as an:
                out["diag"] = an.execute(analysis.tar("train_diag").attr("v")
                                         .select()).array
            log(f"[train] staged {sink.staged_arrays} arrays, "
                f"{sink.staged_bytes / 1e6:.1f} MB into SAVIME; it holds "
                f"{out['diag'].shape[0]} step diagnostics, last loss "
                f"{out['diag'][-1, 0]:.3f}")
    if sink is not None:
        # read once every server has stopped: the session's close collects
        # its channel stats
        out["transfer"] = sink.session.stats.as_dict()
        out["staging"] = dict(staging.stats)
    return out


def _train_rank(argv: list) -> dict:
    """One rank of a launcher run on a mesh (``run_ranks`` calls it)."""
    args = build_parser().parse_args(argv)
    reset_launches()
    return train(args, mesh=build_mesh(args.mesh))


def main(argv=None) -> dict:
    """Parse ``argv`` and train; on a mesh of more than one rank, one
    process a rank. Returns rank 0's results."""
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        shape, axes = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    model_n = dict(zip(axes, shape)).get("model", 1)
    if model_n > 1 and args.mesh not in ("single", "multi"):
        from repro_torch.train.sharding import head_plan
        cfg = get_config(args.arch)
        try:
            head_plan(cfg.smoke() if args.smoke else cfg, model_n, 0)
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
    n = math.prod(shape)
    if n == 1:
        return train(args, mesh=build_mesh(args.mesh))
    if args.mesh in ("single", "multi"):
        build_mesh(args.mesh)     # raises: this is one process, not n ranks
    argv = list(argv if argv is not None else sys.argv[1:])
    if args.ckpt_dir is None:     # one directory every rank reads
        argv += ["--ckpt-dir", tempfile.mkdtemp(prefix="repro-torch-ckpt-")]
    return run_ranks(_train_rank, n, argv)[0]


if __name__ == "__main__":
    main()
