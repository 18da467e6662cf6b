#!/usr/bin/env python3
"""Where the time goes in the port's training step, on one GPU.

    python3 tools/profile_train.py

Builds the training cell of ``chip_smoke.py`` (``chip_smoke.TRAIN``:
gemma2-27b at published widths with its depth cut to 2 layers, remat
"full", 2 microbatches of 1 x 4600 tokens, grads_int8 egress), runs two
steps to warm up, then traces one more with torch.profiler. It prints the
step's wall time, the summed device time of its kernels, the number of
launches, the device's idle share (1 - kernel time / wall time; kernels run
on one stream), the device time of the kernels launched inside each named
range (the flash kernel's forward, the plain attention backward, AdamW,
the egress; each runs on one thread, so its kernels are its children), the
device time by kind of kernel and the kernels with the most device time.
The last line is a JSON summary.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOP = 15   # kernels listed
# kernel-name fragments -> kind; the first that matches wins
KINDS = (("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
         ("flash_attention", ("flash_fwd",)),
         ("softmax/reduce", ("reduce", "softmax", "logsumexp", "norm")),
         ("index/scatter", ("index", "scatter", "gather", "embedding")),
         ("copy/cast", ("copy", "cat", "fill", "memcpy", "memset")),
         ("elementwise", ("elementwise", "vectorized", "unrolled", "tanh")),
         ("pack", ("staging_pack",)))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import TRAIN, card_line, cell_config
    from repro_torch.data import DataConfig, SyntheticLM, batch_to_device
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import Model
    from repro_torch.train import TrainConfig, TrainSetup
    from repro_torch.train import train_step as train_step_mod

    if not torch.cuda.is_available():
        sys.exit("tools/profile_train.py needs a GPU")
    card = card_line()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(cell_config(TRAIN), remat="full")
    setup = TrainSetup(Model(cfg), TrainConfig(
        peak_lr=TRAIN["peak_lr"], warmup_steps=TRAIN["warmup_steps"],
        total_steps=TRAIN["steps"], egress="grads_int8",
        egress_blocks=TRAIN["egress_blocks"], microbatches=TRAIN["microbatches"]))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                                  global_batch=TRAIN["global_batch"],
                                  seed=TRAIN["seed"])).batches()
    state = setup.init_state(TRAIN["seed"], dev)
    step = setup.step_fn()

    ranges = {"train/flash_attention_fwd": (fa_kernel, "flash_attention"),
              "train/plain_attention_backward": (fa_ref, "attention_ref_vjp"),
              "train/adamw_update": (train_step_mod, "adamw_update"),
              "train/egress": (setup, "_egress")}

    @contextlib.contextmanager
    def named_ranges():
        kept = {}
        for name, (obj, attr) in ranges.items():
            fn = getattr(obj, attr)
            kept[name] = fn

            def wrapped(*a, _fn=fn, _name=name, **kw):
                with record_function(_name):
                    return _fn(*a, **kw)
            setattr(obj, attr, wrapped)
        try:
            yield
        finally:
            for name, (obj, attr) in ranges.items():
                if obj is setup:
                    delattr(obj, attr)     # back to the class's method
                else:
                    setattr(obj, attr, kept[name])

    for _ in range(2):                     # warm-up
        state, _, _ = step(state, batch_to_device(next(data), dev))
    batch = batch_to_device(next(data), dev)
    torch.cuda.synchronize()
    with named_ranges(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels, by_range = [], {name: {"calls": 0, "device_ms": 0.0} for name in ranges}
    for e in prof.events():
        if e.name in ranges and e.device_type == torch.autograd.DeviceType.CPU:
            by_range[e.name]["calls"] += 1
            us = getattr(e, "device_time_total", None)
            by_range[e.name]["device_ms"] += (e.cuda_time_total if us is None
                                              else us) / 1e3
    for e in prof.key_averages():
        # the ranges show on the device's timeline too: they are no kernels
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in ranges:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append({"kernel": e.key[:100], "calls": e.count, "ms": us / 1e3,
                        "kind": kind_of(e.key)})
    kernels.sort(key=lambda r: -r["ms"])
    device_ms = sum(r["ms"] for r in kernels)
    by_kind: dict[str, float] = {}
    for r in kernels:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + r["ms"]
    summary = {
        "card": card, "config": f"{cfg.name} n_layers={cfg.n_layers} remat={cfg.remat}",
        "tokens": TRAIN["global_batch"] * TRAIN["seq_len"],
        "microbatches": TRAIN["microbatches"], "loss": float(metrics["loss"]),
        "wall_ms": wall_ms, "device_ms": device_ms,
        "kernel_launches": sum(r["calls"] for r in kernels),
        "idle_share": 1 - device_ms / wall_ms,
        "ranges": by_range, "by_kind_ms": dict(sorted(by_kind.items(),
                                                       key=lambda kv: -kv[1])),
        "top_kernels": kernels[:TOP]}
    print(f"[profile] train step: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, "
          f"{summary['kernel_launches']} kernel launches; idle share "
          f"{summary['idle_share']:.4f}")
    for name, r in by_range.items():
        print(f"[profile]   range {name}: {r['device_ms']:.3f} ms device, x{r['calls']}")
    for kind, ms in summary["by_kind_ms"].items():
        print(f"[profile]   kind {kind}: {ms:.3f} ms")
    for r in kernels[:TOP]:
        print(f"[profile]   {r['ms']:9.3f} ms  x{r['calls']:<5} [{r['kind']}] {r['kernel']}")
    print(card)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
