"""End-to-end training on the PyTorch port with the paper's technique as a
first-class feature, the twin of ``examples/train_with_intransit.py``: a
real model (reduced gemma2 family) trains for a few hundred steps while

  * per-step diagnostics (loss, grad-norm) and int8-packed gradient blocks
    flow through libstaging -> tmpfs -> SAVIME (asynchronously); on the
    card the blocks are packed by the staging_pack kernel, and every
    attention layer runs the flash-attention kernel,
  * checkpoints are written asynchronously,
  * one step failure is INJECTED and recovered from the last checkpoint.

    PYTHONPATH=src python examples/torch_train_with_intransit.py --device cpu [--steps 200]
"""
import argparse
import tempfile
import time

from repro_torch.analysis import AnalysisSession, tar
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import (InTransitConfig, InTransitSink, SavimeServer,
                              StagingServer)
from repro_torch.data import DataConfig, SyntheticLM, batch_to_device
from repro_torch.launch.train import stage_egress
from repro_torch.models import Model
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.train import TrainConfig, TrainSetup

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--arch", default="gemma2-27b")
ap.add_argument("--device", default="cuda",
                help="cuda (default) or cpu; cuda raises when absent")
ap.add_argument("--ckpt-every", type=int, default=50)
args = ap.parse_args()

cfg = get_config(args.arch).smoke()
model = Model(cfg)
print(f"[setup] {cfg.name}: {cfg.param_count() / 1e6:.2f}M params on "
      f"{args.device}")

savime = SavimeServer().start()
staging = StagingServer(savime.addr).start()
sink = InTransitSink(staging.addr,
                     InTransitConfig(io_threads=2, tar_prefix="train",
                                     transport="rdma_staged",
                                     max_inflight_bytes=512 << 20))

setup = TrainSetup(model, TrainConfig(
    peak_lr=5e-3, warmup_steps=20, total_steps=args.steps,
    egress="grads_int8", egress_blocks=16))
state = setup.init_state(0, args.device)
ckpt = CheckpointManager(tempfile.mkdtemp(prefix="repro-torch-example-ckpt-"),
                         sink=None)

step_fn = setup.step_fn()
dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
raw = SyntheticLM(dc).batches()


def wrapped_step(state, batch):
    state, metrics, egress = step_fn(state, batch)
    # in-transit egress: never blocks the hot loop
    stage_egress(sink, egress, int(state["step"]))
    return state, metrics, egress


def batches():
    for b in raw:
        yield batch_to_device(b, args.device)


sup = Supervisor(wrapped_step, ckpt,
                 SupervisorConfig(ckpt_every=args.ckpt_every))
t0 = time.perf_counter()
state = sup.run(state, batches(), args.steps,
                abstract_state=setup.state_specs(), device=args.device,
                fail_at={args.steps // 2})   # injected failure
dt = time.perf_counter() - t0
ckpt.close()

losses = [m["loss"] for m in sup.metrics_log if "loss" in m]
print(f"[train] {args.steps} steps in {dt:.1f}s; "
      f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
      f"restarts={sup.restarts}")
assert losses[-1] < losses[0]
assert sup.restarts == 1

sink.flush()
with AnalysisSession(savime.addr) as an:
    diag = an.execute(tar("train_diag").attr("v").select()).array
print(f"[analysis] SAVIME holds {diag.shape[0]} step diagnostics; "
      f"last staged loss={diag[-1, 0]:.3f}")
assert diag.shape[0] == args.steps
sink.close()
staging.stop()
savime.stop()
print("OK")
