#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, each of which makes the script exit non-zero when it fails:
  1. device: CUDA must be present; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the port from the sources in
     this checkout (nvcc, sm_90a) and times it;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the reference test cases, ragged lengths and the gemma2-27b prefill
     shapes, element by element within the limits stated below;
  4. serve: gemma2-27b at full width (depth cut to 4 layers, two local/global
     periods) serves 4 prompts of 4600 tokens plus 32 greedy tokens through
     ``repro_torch.launch.serve.serve``; the kernel's launch count over that
     run must be one per layer, the logits finite, and the prefill logits
     must match the same model run through the plain attention;
  5. timing: each kernel, its plain version and the library call that
     computes the same function, at the shapes the serve path gives it.

The last lines are a JSON summary of the kernels, the card line, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 FMA, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# kernel against its plain version on the same input values, the plain one
# left in f32: |err| <= REL * |ref| + ATOL per element. ATOL covers fp32 sums
# taken in another order; a bf16 output rounded to nearest even is within half
# a bf16 step of the f32 value, and half a step is at most 2**-8 of it
# (truncating instead of rounding misses this by up to a whole step).
ATOL = 2e-5
REL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
# serve: prefill logits of the kernel path against the plain-attention path,
# both in bf16 compute: max |err| <= LOGITS_REL * mean |logit| of the plain path
LOGITS_REL = 0.125

GEMMA_SHAPE = dict(Hq=32, Hkv=16, D=128, scale=(4608 / 32) ** -0.5, cap=50.0)
SERVE = dict(batch=4, prompt_len=4600, new_tokens=32, n_layers=4, seed=0)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def visible_keys(S: int, causal: bool, window: int) -> int:
    """Sum over query rows of the keys the mask lets each row see (Sq = Sk)."""
    q = np.arange(S, dtype=np.int64)
    hi = q + 1 if causal else np.full(S, S)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, np.int64)
    return int(np.sum(hi - lo))


def attention_bound_ms(B, S, Hq, Hkv, D, causal, window, dtype) -> tuple[float, str]:
    """Least time for one call: bytes (q, k, v read once, o written once) over
    HBM rate against 4*B*Hq*D*sum|visible k| operations over the dtype's peak."""
    esize = 4 if dtype == "float32" else 2
    nbytes = B * S * (2 * Hq + 2 * Hkv) * D * esize
    flops = 4 * B * Hq * D * visible_keys(S, causal, window)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, build, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import attention as attention_mod

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = {name: build.build(name) for name in build.SOURCES}
    log(f"build: {sorted(build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(1234)

    def qkv(B, Sq, Sk, Hq, Hkv, D, dtype):
        mk = lambda S, H: torch.randn((B, S, H, D), generator=gen,  # noqa: E731
                                      device=dev, dtype=torch.float32).to(dtype)
        return mk(Sq, Hq), mk(Sk, Hkv), mk(Sk, Hkv)

    def compare(q, k, v, what, **kw) -> tuple[float, float]:
        """Kernel against the plain version on the same input values, in f32;
        fails beyond REL * |ref| + ATOL. Returns (max |err|, mean |ref|)."""
        dname = str(q.dtype).split(".")[-1]
        o_k = ops.gqa_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        o_p = ops.gqa_attention_ref(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        if o_k.shape != o_p.shape or o_k.dtype != q.dtype:
            fail(f"kernel output {tuple(o_k.shape)} {o_k.dtype}")
        err = (o_k.float() - o_p).abs()
        within = bool((err <= REL[dname] * o_p.abs() + ATOL).all())
        max_err, mean_ref = float(err.max()), float(o_p.abs().mean())
        log(f"flash_attention {dname} {what}: max|err| {max_err:.3g}, "
            f"mean|ref| {mean_ref:.3g} (limit {REL[dname]:.3g}*|ref| + {ATOL}) "
            f"{'ok' if within else 'MISMATCH'}")
        if not within:
            fail(f"flash_attention disagrees with its plain version: {what} {dname}")
        return max_err, mean_ref

    # -- 3. kernel against its plain version -----------------------------------
    cases = [  # the reference's cases (tests/test_kernels.py), then ragged ones
        dict(B=2, Sq=256, Sk=256, Hq=4, Hkv=2, D=64, window=0, cap=0.0, causal=True),
        dict(B=1, Sq=512, Sk=512, Hq=8, Hkv=1, D=128, window=0, cap=50.0, causal=True),
        dict(B=2, Sq=256, Sk=256, Hq=4, Hkv=4, D=64, window=128, cap=0.0, causal=True),
        dict(B=1, Sq=256, Sk=256, Hq=2, Hkv=2, D=64, window=0, cap=0.0, causal=False),
        dict(B=2, Sq=300, Sk=300, Hq=4, Hkv=1, D=128, window=100, cap=50.0, causal=True),
        dict(B=1, Sq=300, Sk=300, Hq=8, Hkv=2, D=16, window=0, cap=0.0, causal=True),
        dict(B=1, Sq=100, Sk=300, Hq=4, Hkv=2, D=32, window=0, cap=30.0, causal=False),
    ]
    for window in (4096, 0):   # gemma2-27b prefill: local, global
        cases.append(dict(B=1, Sq=4600, Sk=4600, Hq=GEMMA_SHAPE["Hq"],
                          Hkv=GEMMA_SHAPE["Hkv"], D=GEMMA_SHAPE["D"],
                          window=window, cap=GEMMA_SHAPE["cap"], causal=True,
                          scale=GEMMA_SHAPE["scale"]))
    worst = {}
    for c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v = qkv(c["B"], c["Sq"], c["Sk"], c["Hq"], c["Hkv"], c["D"], dtype)
            err, _ = compare(q, k, v, c, scale=c.get("scale", 0.0),
                             softcap=c["cap"], causal=c["causal"],
                             window=c["window"])
            worst[dname] = max(worst.get(dname, 0.0), err)
            del q, k, v
    torch.cuda.empty_cache()

    # -- 4. the serve path -----------------------------------------------------
    cfg = dataclasses.replace(get_config("gemma2-27b"), n_layers=SERVE["n_layers"])
    log(f"serve: {cfg.name} at published widths (d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, window {cfg.attn_window}, caps "
        f"{cfg.attn_softcap}/{cfg.logit_softcap}); reduced: n_layers 46 -> "
        f"{cfg.n_layers} (two local/global periods, stacked scan layout)")
    kw = dict(batch=SERVE["batch"], prompt_len=SERVE["prompt_len"],
              new_tokens=SERVE["new_tokens"], seed=SERVE["seed"], device=dev,
              log=log)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    first = serve(cfg, **kw)
    launches = dict(LAUNCHES)
    log(f"serve launches: {launches}")
    if launches["flash_attention"] != cfg.n_layers:
        fail(f"flash_attention launched {launches['flash_attention']} times on "
             f"the serve path, want {cfg.n_layers} (one per layer's prefill)")
    params, prompts = first["params"], first["prompts"]
    B, N, V = SERVE["batch"], SERVE["new_tokens"], cfg.vocab_size
    lg = first["prefill_logits"]
    if lg.shape != (B, V) or not bool(torch.isfinite(lg).all()):
        fail(f"prefill logits {tuple(lg.shape)} not finite or misshaped")
    toks = first["tokens"]
    if toks.shape != (B, N) or int(toks.min()) < 0 or int(toks.max()) >= V:
        fail(f"generated tokens {tuple(toks.shape)} out of range")

    # the same model, params and prompts through the plain attention
    attention_mod.gqa_attention = ops.gqa_attention_ref
    try:
        reset_launches()
        plain = serve(cfg, **kw, params=params, prompts=prompts)
    finally:
        attention_mod.gqa_attention = ops.gqa_attention
    if LAUNCHES["flash_attention"] != 0:
        fail("the plain-attention run launched the kernel")
    ref_lg = plain["prefill_logits"].float()
    logit_err = float((lg.float() - ref_lg).abs().max())
    logit_mean = float(ref_lg.abs().mean())
    agree = int((toks == plain["tokens"]).sum())
    log(f"serve: prefill logits kernel vs plain max|err| {logit_err:.3g}, "
        f"mean|logit| {logit_mean:.3g}, max|logit| {float(ref_lg.abs().max()):.3g} "
        f"(limit {LOGITS_REL}*mean|logit| = {LOGITS_REL * logit_mean:.3g}); "
        f"greedy tokens agreeing {agree}/{B * N}")
    if not logit_err <= LOGITS_REL * logit_mean:
        fail("prefill logits of the kernel path disagree with the plain path")

    # a second kernel-path run, warm, for the serve times
    reset_launches()
    timed = serve(cfg, **kw, params=params, prompts=prompts)
    if LAUNCHES["flash_attention"] != cfg.n_layers:
        fail(f"timed run launched the kernel {LAUNCHES['flash_attention']} times")
    lat = np.asarray(timed["decode_ms"])
    serve_stats = {
        "prefill_ms": timed["prefill_ms"], "plain_prefill_ms": plain["prefill_ms"],
        "decode_p50_ms": float(np.percentile(lat, 50)),
        "decode_p99_ms": float(np.percentile(lat, 99)),
        "tokens_agree": agree, "tokens": B * N,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"serve (warm): {json.dumps(serve_stats)}")
    del first, plain, timed, params, lg
    torch.cuda.empty_cache()

    # -- 5. timing at the serve path's shapes ------------------------------------
    def time_ms(fn, reps=3) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    Bs, S = SERVE["batch"], SERVE["prompt_len"]
    g = GEMMA_SHAPE
    q, k, v = qkv(Bs, S, S, g["Hq"], g["Hkv"], g["D"], torch.bfloat16)
    t = {}
    for name, window in (("local", cfg.attn_window), ("global", 0)):
        akw = dict(scale=g["scale"], softcap=g["cap"], causal=True, window=window)
        err, mean_ref = compare(q, k, v, f"serve shape B={Bs} S={S} ({name})",
                                **akw)
        worst["serve_shape"] = max(worst.get("serve_shape", 0.0), err)
        t[name] = dict(
            ms=time_ms(lambda: ops.gqa_attention(q, k, v, **akw)),
            plain_ms=time_ms(lambda: ops.gqa_attention_ref(q, k, v, **akw)),
            bound=attention_bound_ms(Bs, S, g["Hq"], g["Hkv"], g["D"], True,
                                     window, "bfloat16"))
        log(f"time {name} (window {window}, cap {g['cap']}): kernel "
            f"{t[name]['ms']:.3f} ms, plain {t[name]['plain_ms']:.3f} ms, bound "
            f"{t[name]['bound'][0]:.3f} ms ({t[name]['bound'][1]})")
    # the library yardstick: SDPA has no softcap, so kernel and SDPA at cap 0
    nocap = dict(scale=g["scale"], softcap=0.0, causal=True, window=0)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      scale=g["scale"], enable_gqa=True))
    cap0_ms = time_ms(lambda: ops.gqa_attention(q, k, v, **nocap))
    log(f"time global cap 0: kernel {cap0_ms:.3f} ms, "
        f"scaled_dot_product_attention {library_ms} ms")

    summary = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
        "launches": launches["flash_attention"],
        "shape": (f"B={Bs} S={S} Hq={g['Hq']} Hkv={g['Hkv']} D={g['D']} bf16 "
                  f"causal window=0 cap={g['cap']} (serve global layer)"),
        "max_abs_err": worst["serve_shape"],
        "mean_abs_ref": mean_ref,
        "ms": t["global"]["ms"],
        "plain_ms": t["global"]["plain_ms"],
        "bound_ms": t["global"]["bound"][0],
        "bound_by": t["global"]["bound"][1],
        "library_ms": library_ms,
        "library_call": "scaled_dot_product_attention(is_causal, enable_gqa), cap 0",
        "ms_cap0": cap0_ms,
        "ms_local": t["local"]["ms"],
        "plain_ms_local": t["local"]["plain_ms"],
        "bound_ms_local": t["local"]["bound"][0],
        "max_abs_err_cases": worst,
    }], "serve": serve_stats}
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
