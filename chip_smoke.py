#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, each of which makes the script exit non-zero when it fails:
  1. device: CUDA must be present; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the port from the sources in
     this checkout (nvcc, sm_90a, one process per source, all started
     together) and prints each kernel's registers, spills and build time
     beside the wall time of the whole build; for the selective scan at the
     model's types, its dynamic shared memory, blocks an SM, and the SASS
     of its inner loop: instructions, MUFU.EX2 (one a state update) and
     SHFL;
  3. kernels: each kernel against its plain PyTorch version on the card,
     element by element within the limits stated below: flash attention at
     the reference test cases, ragged lengths and the gemma2-27b prefill
     shapes, and the mask probe (an input whose answer is exact) at the
     reference cases; the selective scan at the reference test cases in
     f32 and bf16, the model's mixed types and ragged cases (N = 1, 4, 5;
     di leaving part of a warp without channels; S = 1, S < chunk,
     S = chunk + 1; rows and B/C slices aligned to 4 bytes or not at all;
     its falcon-mamba-7b prefill shape is checked in phase 5); before them,
     the SASS of the flash-attention library must hold HGMMA (wgmma) ops;
  4. serve, one cell after the other (``CELLS``), each through
     ``repro_torch.launch.serve.serve``: 4 prompts of 4600 tokens plus 32
     greedy tokens, random weights from seed 0. gemma2-27b at full width
     with its depth cut to 4 layers; falcon-mamba-7b at full width and full
     depth (64 layers). The cell's kernel must launch once per layer (its
     prefill), the logits must be finite, and the prefill logits must
     match the same model served through the kernel's plain version; then
     a warm run gives the serve times. In gemma2-27b's plain-attention run
     the kernel also runs on each layer's served q, k, v, in lockstep, and
     is held to its per-element limit there. In falcon-mamba-7b's plain-scan run
     the kernel also runs beside the plain scan in lockstep, on each
     layer's own input, and is held to the scan's per-element limit there;
     that run also reads the residual stream after every layer. A last
     run of that cell, its scan outputs nudged by one bf16 step in a small
     share, reads how far its logits gate lets a kernel's rounding stray;
  5. timing: each kernel, checked once more against its plain version
     (flash attention also by the mask probe, local and global), then timed
     with its plain version, its bound and the library call that computes
     the same function (where there is one), at the shapes the serve path
     gives it;
  6. in transit: the paper's producer path at its HPC4e mesh (201x501x501,
     50,451,201 float32 values a step). ``SeismicField`` makes each step on
     the card and the port's ``InTransitSink`` stages it through the port's
     staging server into its SAVIME while an analyst thread watches the
     arrivals and queries each step as it lands, as
     ``examples/torch_simulation_intransit.py`` does: 8 steps with
     ``codec="int8-block"`` (each step quantized on the card by the pack
     kernel, which must launch once a step; the step read back must equal
     the host codec's decode and lie within the quantization bound of the
     field), then the same 8 steps with ``codec="none"`` (a full float32
     copy to the host a step), for the comparison the paper makes; then one
     step of the mesh in bfloat16, once with each codec, read back equal to
     the host codec's decode (int8-block) or to its bits (none); then the
     pack kernel is timed at that mesh.

The pack kernel is checked in phase 3 too, byte for byte against its plain
version (reference cases, the codec's ragged sizes, exact ties, the full
mesh) and against the numpy host codec at the full mesh and for float16.

The last lines are a JSON summary of the kernels, the card line, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 FMA, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# The SFU (MUFU) computes 16 exponentials a clock per SM (NVIDIA's table of
# arithmetic throughput for compute capability 9.0): 132 SMs at the 1.98 GHz
# boost clock the data sheet's 67 TFLOP/s fp32 assumes.
PEAK_EXPS = 132 * 16 * 1.98e9
# flash attention against its plain version on the same input values, the
# plain one left in f32: |err| <= kernel_error_limit per element
# (kernels/flash_attention/ref.py). f32: 2e-5, fp32 sums taken in another
# order. bf16 (the tensor-core instance rounds P to bf16 before P V):
# 2**-8 * |ref| + 2**-8 * (P |V|) + 2e-5, P |V| being the plain version run
# on |v|; on the mask probe, where every p is exact, 2**-8 * |ref| + 2e-5.
# selective scan: y and h_last must equal the plain version's result, rounded
# to the kernel's output dtype, element for element. The kernel performs the
# plain version's roundings in its order (no FMA contraction, the state sum by
# halving, expf as torch.exp), so any difference is a departure from the plain
# arithmetic; 64 random-weight mamba layers amplify a one-ulp difference in y
# until the served logits are unrelated, so nothing looser would let phase 4
# hold this cell's served model to its plain path (the lockstep run of phase 4
# prints that growth). (Against the plain result in f32, a bf16 y is then
# within half a bf16 step; the reference's own limits are 5e-5 for f32 and
# 5e-2 for bf16.)
# serve: prefill logits of the kernel path against the plain path, both in
# bf16 compute: max |err| <= LOGITS_REL * mean |logit| of the plain path
LOGITS_REL = 0.125
# the nudge probe of the falcon-mamba cell moves one scan output in this many
NUDGE_EVERY = 1024

GEMMA_SHAPE = dict(Hq=32, Hkv=16, D=128, scale=(4608 / 32) ** -0.5, cap=50.0)
SERVE = dict(arch="gemma2-27b", batch=4, prompt_len=4600, new_tokens=32,
             n_layers=4, seed=0, kernel="flash_attention",
             reduced="n_layers 46 -> 4 (two local/global periods, stacked "
                     "scan layout): 46 layers of f32 params do not fit 80 GB")
SERVE_MAMBA = dict(arch="falcon-mamba-7b", batch=4, prompt_len=4600,
                   new_tokens=32, n_layers=64, seed=0, kernel="ssm_scan",
                   reduced="none: full depth, 64 layers (stacked scan layout)")
CELLS = (SERVE, SERVE_MAMBA)
# the in-transit path: the paper's HPC4e velocity mesh (SeismicField's
# docstring), staged as float32, 8 steps a codec; the int8-block codec's block
# and the staging_pack tile it packs with
MESH = dict(nx=201, ny=501, nz=501)
INTRANSIT_STEPS = 8
CODEC_BLOCK = 4096
PACK_TILE = (CODEC_BLOCK // 128, 128)
# the staging server's memory tier lives in /dev/shm: at most this share of it
SHM_SHARE = 0.5
MAX_STAGING_MEM = 4 << 30


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


def cell_config(cell: dict):
    """The cell's model: the registry's config at the cell's depth."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(cell["arch"]),
                               n_layers=cell["n_layers"])


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


def scan_bound_ms(inputs, outputs) -> tuple[float, str, dict]:
    """Least time for one scan call: the bytes of every input read once and
    every output written once over the HBM rate, against the operations:
    B*S*di*N exponentials over the SFU rate, and the fp32 arithmetic around
    them (dt*A, decay*h, dx*B_t, h*C_t: 6 flops per state update, plus
    dt*x per channel) over the fp32 peak. The larger of the three."""
    xi, A = inputs[0], inputs[4]
    B, S, di = xi.shape
    N = A.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    exps = B * S * di * N
    flops = B * S * di * (6 * N + 1)
    times = {"bytes": nbytes / PEAK_BYTES, "exps": exps / PEAK_EXPS,
             "flops": flops / PEAK_FLOPS["float32"]}
    worst = max(times, key=times.get)
    detail = {"bytes": nbytes, "exps": exps, "flops": flops,
              **{f"{k}_ms": v * 1e3 for k, v in times.items()}}
    return times[worst] * 1e3, ("bytes" if worst == "bytes" else "operations"), detail


def shm_free_bytes() -> int:
    """Prints ``df -B1 /dev/shm`` and returns its available bytes."""
    out = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    log("df -B1 /dev/shm: " + " | ".join(out.strip().splitlines()))
    return int(out.strip().splitlines()[-1].split()[3])


def pack_bound_ms(x, q, s) -> tuple[float, str, dict]:
    """Least time for one quantizing pack: x read once, the int8 blocks and
    the scales written once, over the HBM rate, against about 8 fp32
    operations an element (|x|, max, x/scale, round, two clamps, convert;
    one division per block) over the fp32 peak. The larger of the two."""
    nbytes = sum(t.numel() * t.element_size() for t in (x, q, s))
    ops_count = 8 * x.numel()
    times = {"bytes": nbytes / PEAK_BYTES, "operations": ops_count / PEAK_FLOPS["float32"]}
    worst = max(times, key=times.get)
    detail = {"bytes": nbytes, "operations": ops_count,
              **{f"{k}_ms": v * 1e3 for k, v in times.items()}}
    return times[worst] * 1e3, worst, detail


def sass_function(sass: str, key: str) -> list[str]:
    """The SASS instruction texts of the first function of a ``cuobjdump
    -sass`` listing whose name holds ``key``, each prefixed by its hex
    address and followed by the labels of the lines before it."""
    out, inside, labels = [], False, []
    for line in sass.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = key in line
            continue
        if not inside:
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            labels.append(label.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+([^;]*);", line)
        if ins:
            out.append((int(ins.group(1), 16), ins.group(2).strip(), labels))
            labels = []
    return out


def sass_inner_loops(sass: str, key: str) -> list[dict]:
    """The innermost loops (a backward branch's range holding no other) of
    function ``key`` that hold MUFU.EX2, each with its instruction count and
    its counts of MUFU.EX2 and SHFL, the loop with the most MUFU.EX2 first."""
    ins = sass_function(sass, key)
    where = {lab: addr for addr, _, labs in ins for lab in labs}
    loops = []
    for addr, text, _ in ins:
        if "BRA" not in text.split():
            continue
        tgt = re.search(r"\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", text)
        if not tgt:
            continue
        target = where.get(tgt.group(1)) if tgt.group(1) else int(tgt.group(2), 16)
        if target is not None and target <= addr:
            loops.append((target, addr))
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    rows = []
    for lo, hi in inner:
        body = [t for a, t, _ in ins if lo <= a <= hi]
        mufu = sum("MUFU.EX2" in t for t in body)
        if mufu:
            rows.append({"instructions": len(body), "mufu_ex2": mufu,
                         "shfl": sum("SHFL" in t for t in body),
                         "per_state_update": len(body) / mufu})
    return sorted(rows, key=lambda r: -r["mufu_ex2"])


@contextlib.contextmanager
def swapped(module, name: str, value):
    """Replace ``module.name`` by ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import torch

    t_start = time.perf_counter()
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

    from repro_torch.codec.int8block import Int8BlockCodec
    from repro_torch.data.seismic import SeismicConfig, SeismicField
    from repro_torch.kernels import LAUNCHES, build, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import ref as attn_ref
    from repro_torch.kernels.staging_pack import kernel as pack_kernel
    from repro_torch.kernels.staging_pack import ops as pack_ops
    from repro_torch.kernels.staging_pack import ref as pack_ref
    from repro_torch.kernels.ssm_scan import kernel as scan_kernel
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as transformer_mod

    # -- 2. build ------------------------------------------------------------
    def timed_build(name: str) -> tuple[str, float]:
        t = time.perf_counter()
        return build.build(name), time.perf_counter() - t

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(build.SOURCES)) as pool:
        futures = {name: pool.submit(timed_build, name) for name in build.SOURCES}
        reports = {name: f.result() for name, f in futures.items()}
    build_s = {name: secs for name, (_, secs) in reports.items()}
    log(f"build: {sorted(build.SOURCES)} in {time.perf_counter() - t0:.1f} s "
        f"wall, in parallel; each nvcc alone took "
        f"{json.dumps({k: round(v, 1) for k, v in build_s.items()})} s "
        f"(sum {sum(build_s.values()):.1f} s)")
    for name, (rep, _) in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    # the bf16 flash-attention instance must run on the tensor cores: wgmma
    # shows in the SASS as HGMMA
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    hgmma = sum(1 for line in sass.splitlines() if "HGMMA" in line)
    log(f"SASS of the flash_attention library: {hgmma} HGMMA instructions "
        f"(wgmma; limit: at least 1)")
    if hgmma == 0:
        fail("the flash_attention library has no HGMMA instruction")
    # the scan at the model's types (x, B, C bf16; dt f32; N = 16): shared
    # memory, blocks an SM, and the SASS of its inner loop (the instance's
    # template arguments <2, 4, 2, true> in the mangled name)
    scan_sass = subprocess.run([str(cuobjdump), "-sass",
                                str(build.library_path("ssm_scan"))],
                               capture_output=True, text=True, timeout=300,
                               check=True).stdout
    scan_loops = sass_inner_loops(scan_sass, "ssm_scan_kernelILi2ELi4ELi2ELb1E")
    scan_launch = scan_kernel.launch_shape(torch.bfloat16, torch.float32,
                                           torch.bfloat16)
    log(f"ssm_scan at the model's types: {scan_launch['smem_bytes']} B of dynamic "
        f"shared memory a block, {scan_launch['blocks_per_sm']} blocks an SM "
        f"(CUDA's occupancy calculator); chunk {scan_kernel.chunk_steps()} "
        f"steps; SASS inner loops holding MUFU.EX2: {json.dumps(scan_loops)} "
        f"(the first: its instructions over its MUFU.EX2, one a state update)")

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def qkv(B, Sq, Sk, Hq, Hkv, D, dtype):
        return (randn(B, Sq, Hq, D).to(dtype), randn(B, Sk, Hkv, D).to(dtype),
                randn(B, Sk, Hkv, D).to(dtype))

    def attention_error(q, k, v, o_k, **kw) -> tuple[float, float, float]:
        """The kernel's output o_k against the plain version in f32 on the
        same input values, under kernel_error_limit. Returns (max |err|,
        max |err| / limit, mean |ref|)."""
        o_p = ops.gqa_attention_ref(q.float(), k.float(), v.float(), **kw)
        pv_abs = (ops.gqa_attention_ref(q.float(), k.float(), v.float().abs(), **kw)
                  if q.dtype == torch.bfloat16 else None)
        err = (o_k.float() - o_p).abs()
        ratio = float((err / attn_ref.kernel_error_limit(o_p, pv_abs,
                                                         dtype=q.dtype)).max())
        return float(err.max()), ratio, float(o_p.abs().mean())

    def compare(q, k, v, what, **kw) -> tuple[float, float]:
        """Kernel against the plain version on the same input values, in f32;
        fails beyond kernel_error_limit. Returns (max |err|, mean |ref|)."""
        dname = str(q.dtype).split(".")[-1]
        o_k = ops.gqa_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if o_k.shape != q.shape or o_k.dtype != q.dtype:
            fail(f"kernel output {tuple(o_k.shape)} {o_k.dtype}")
        max_err, ratio, mean_ref = attention_error(q, k, v, o_k, **kw)
        torch.cuda.synchronize()
        log(f"flash_attention {dname} {what}: max|err| {max_err:.3g}, "
            f"mean|ref| {mean_ref:.3g}, max |err|/limit {ratio:.3f} (limit 1: "
            f"{'2e-5' if dname == 'float32' else '2^-8*|ref| + 2^-8*P|V| + 2e-5'}) "
            f"{'ok' if ratio <= 1 else 'MISMATCH'}")
        if not ratio <= 1:
            fail(f"flash_attention disagrees with its plain version: {what} {dname}")
        return max_err, mean_ref

    def probe(B, S, Hq, Hkv, D, what, **kw) -> float:
        """The mask probe in bf16 (q = 0, v = (-1)**k: every p is 1, the
        answer exact); fails beyond the tight 2**-8 * |ref| + 2e-5. Returns
        max |err| / limit."""
        q, k, v = attn_ref.mask_probe(B, S, S, Hq, Hkv, D, dtype=torch.bfloat16,
                                      device=dev)
        o = ops.gqa_attention(q, k, v, **kw)
        want = attn_ref.mask_probe_answer(B, S, S, Hq, D, causal=kw["causal"],
                                          window=kw["window"], device=dev)
        ratio = float(((o.float() - want).abs()
                       / attn_ref.kernel_error_limit(want, dtype=torch.bfloat16)).max())
        log(f"flash_attention mask probe bf16 {what}: max |err|/limit {ratio:.3f} "
            f"(limit 1: 2^-8*|ref| + 2e-5) {'ok' if ratio <= 1 else 'MISMATCH'}")
        if not ratio <= 1:
            fail(f"flash_attention fails the mask probe: {what}")
        return ratio

    def scan_inputs(B, S, di, N, x_dt, dt_dt, bc_dt, dt_rank=0):
        """The reference test's distribution (dt = softplus(normal) * 0.1,
        A = -exp(0.2 * normal)); Bm and Cm are column slices of one
        (B, S, dt_rank + 2N) buffer, as the model's x_proj output gives them."""
        xi = randn(B, S, di).to(x_dt)
        dt = (torch.nn.functional.softplus(randn(B, S, di)) * 0.1).to(dt_dt)
        bc = randn(B, S, dt_rank + 2 * N).to(bc_dt)
        Bm, Cm = bc[..., dt_rank:dt_rank + N], bc[..., dt_rank + N:]
        A = -torch.exp(randn(di, N) * 0.2)
        h0 = randn(B, di, N)
        return xi, dt, Bm, Cm, A, h0

    def compare_scan(inputs, what) -> tuple[float, float]:
        """Scan kernel against the plain version on the same input values, in
        f32; y and h_last must equal the plain result rounded to their dtype.
        Returns (max |err| of y against the f32 plain y, mean |ref| of y)."""
        xi = inputs[0]
        types = "/".join(str(t.dtype).split(".")[-1] for t in inputs[:3])
        y, h = scan_ops.selective_scan(*inputs)
        torch.cuda.synchronize()
        y_p, h_p = ssm_scan_ref(*(t.float() for t in inputs))
        torch.cuda.synchronize()
        if y.shape != y_p.shape or y.dtype != xi.dtype or h.shape != h_p.shape \
                or h.dtype != torch.float32:
            fail(f"scan kernel output y {tuple(y.shape)} {y.dtype}, h_last "
                 f"{tuple(h.shape)} {h.dtype}")
        res = {}
        for name, got, want in (("y", y, y_p), ("h_last", h, h_p)):
            err = (got.float() - want).abs()
            same = got == want.to(got.dtype)
            ok = bool(same.all())
            res[name] = (float(err.max()), float(want.abs().mean()), ok)
            log(f"ssm_scan {types} (xi/dt/BC) {what} {name}: share equal to "
                f"the plain result in {str(got.dtype).split('.')[-1]} "
                f"{float(same.float().mean())} (limit: all); max|err| against "
                f"the f32 plain result {res[name][0]:.3g} (at most half a "
                f"step of the output dtype), mean|ref| {res[name][1]:.3g} "
                f"{'ok' if ok else 'MISMATCH'}")
        if not (res["y"][2] and res["h_last"][2]):
            fail(f"ssm_scan disagrees with its plain version: {what} {types}")
        return res["y"][0], res["y"][1]

    # -- 3. kernels against their plain versions ---------------------------------
    cases = [  # the reference's cases (tests/test_kernels.py), then ragged ones
        dict(B=2, Sq=256, Sk=256, Hq=4, Hkv=2, D=64, window=0, cap=0.0, causal=True),
        dict(B=1, Sq=512, Sk=512, Hq=8, Hkv=1, D=128, window=0, cap=50.0, causal=True),
        dict(B=2, Sq=256, Sk=256, Hq=4, Hkv=4, D=64, window=128, cap=0.0, causal=True),
        dict(B=1, Sq=256, Sk=256, Hq=2, Hkv=2, D=64, window=0, cap=0.0, causal=False),
        dict(B=2, Sq=300, Sk=300, Hq=4, Hkv=1, D=128, window=100, cap=50.0, causal=True),
        dict(B=1, Sq=300, Sk=300, Hq=8, Hkv=2, D=16, window=0, cap=0.0, causal=True),
        dict(B=1, Sq=100, Sk=300, Hq=4, Hkv=2, D=32, window=0, cap=30.0, causal=False),
        # the wgmma instance without a causal mask: its ragged last kv tile
        # is masked only by the Sk test (301 keys: the probe's sum is odd)
        dict(B=1, Sq=301, Sk=301, Hq=4, Hkv=2, D=128, window=0, cap=0.0, causal=False),
        dict(B=1, Sq=100, Sk=300, Hq=4, Hkv=2, D=64, window=0, cap=30.0, causal=False),
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
        if c["Sq"] == c["Sk"] and c["D"] in (64, 128):   # the wgmma instance
            probe(c["B"], c["Sq"], c["Hq"], c["Hkv"], c["D"], c, scale=c.get("scale", 0.0),
                  softcap=c["cap"], causal=c["causal"], window=c["window"])
    torch.cuda.empty_cache()

    mcfg = cell_config(SERVE_MAMBA)
    scan_shape = dict(B=SERVE_MAMBA["batch"], S=SERVE_MAMBA["prompt_len"],
                      di=mcfg.d_inner, N=mcfg.ssm.d_state)
    mixed = (torch.bfloat16, torch.float32, torch.bfloat16)   # the model's types
    scan_cases = [(shape, (dtype,) * 3) for dtype in (torch.float32, torch.bfloat16)
                  for shape in ((2, 64, 256, 16), (1, 100, 300, 8),
                                (2, 128, 512, 16))]   # tests/test_kernels.py
    chunk = scan_kernel.chunk_steps()
    scan_cases += [((2, 200, 1000, 16), mixed),
                   ((3, 1, 77, 16), mixed),           # ragged: S = 1, di % 32 != 0
                   ((1, 130, 100, 5), mixed),         # ragged S, di and N
                   ((2, 50, 256, 1), mixed),          # N = 1: lanes 1..3 hold no state
                   ((2, 50, 256, 4), mixed),          # N = 4: one state a lane
                   ((1, 70, 36, 16), mixed),          # part of a warp without channels
                   ((2, 40, 130, 16), (torch.bfloat16,) * 3),   # 4-byte rows
                   ((2, 40, 77, 16), (torch.float32,) * 3),     # 4-byte rows
                   ((2, chunk - 7, 200, 16), mixed),  # S < chunk
                   ((2, chunk + 1, 200, 16), mixed)]  # S = chunk + 1
    # B/C column slices of a (B, S, 3N) buffer (dt_rank = N = 5): a sequence
    # stride of 30 B (bf16), the B slice not even 4-byte aligned
    scan_cases = [(shape, types, 0) for shape, types in scan_cases]
    scan_cases += [((1, 100, 128, 5), mixed, 5), ((1, 100, 128, 5), (torch.float32,) * 3, 5)]
    scan_worst = {}
    for shape, types, dt_rank in scan_cases:   # h0 random, nonzero
        err, _ = compare_scan(scan_inputs(*shape, *types, dt_rank=dt_rank),
                              f"B,S,di,N={shape} dt_rank={dt_rank}")
        dname = str(types[0]).split(".")[-1]
        scan_worst[dname] = max(scan_worst.get(dname, 0.0), err)

    def compare_pack(got, want, what) -> int:
        """Pack kernel against its plain version on the same input: blocks
        and scales must be equal byte for byte (both divide in IEEE f32 and
        round half to even). Returns max |err| of the blocks."""
        (b, s), (b_p, s_p) = got, want
        torch.cuda.synchronize()
        if b.shape != b_p.shape or b.dtype != b_p.dtype or s.shape != s_p.shape:
            fail(f"staging_pack {what}: kernel gave {tuple(b.shape)} {b.dtype}, "
                 f"plain {tuple(b_p.shape)} {b_p.dtype}")
        same_b = b.view(torch.uint8) == b_p.view(torch.uint8) if b.numel() else \
            torch.ones(1, dtype=torch.bool, device=dev)
        ok = bool(same_b.all()) and torch.equal(s.view(torch.int32),
                                                s_p.view(torch.int32))
        err = int((b.float() - b_p.float()).abs().max()) if b.numel() else 0
        log(f"staging_pack {what}: blocks {tuple(b.shape)} "
            f"{str(b.dtype).split('.')[-1]}; share of bytes equal to the plain "
            f"version {float(same_b.float().mean())} (limit: all), scales "
            f"equal {torch.equal(s, s_p)}; max|err| {err} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"staging_pack disagrees with its plain version: {what}")
        return err

    def plain_quantize(x):
        """The codec variant's plain version: pad to whole blocks, then pack."""
        nb = -(-x.numel() // CODEC_BLOCK)
        xp = torch.nn.functional.pad(x.reshape(-1), (0, nb * CODEC_BLOCK - x.numel()))
        return pack_ref.pack_blocks_ref(xp.reshape(-1, PACK_TILE[1]), tile=PACK_TILE,
                                        out_dtype=torch.int8)

    pack_worst = 0
    for shape, tile in (((256, 128), (256, 128)), ((512, 256), (256, 128)),
                        ((64, 384), (8, 128))):       # tests/test_kernels.py
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = randn(*shape).to(dtype)
            # a float16 input packs to int8, bf16 or f32 (no float16 output)
            outs = (None, torch.int8, torch.bfloat16) if dtype != torch.float16 \
                else (torch.int8, torch.bfloat16, torch.float32)
            for out in outs:
                pack_worst = max(pack_worst, compare_pack(
                    pack_kernel.pack_blocks(x, tile=tile, out_dtype=out),
                    pack_ref.pack_blocks_ref(x, tile=tile, out_dtype=out),
                    f"{shape} tile {tile} {str(dtype).split('.')[-1]} -> "
                    f"{str(out or dtype).split('.')[-1]}"))
    for n in (0, 1, 4096, 5000, 3 * 4096 + 17):
        x = randn(n) * 3
        pack_worst = max(pack_worst, compare_pack(
            pack_ops.quantize_blocks(x, block_elems=CODEC_BLOCK), plain_quantize(x),
            f"quantize_blocks n={n}"))
    ties = torch.tensor([70.5, -70.5, 0.5, 1.5, 2.5, -2.5, 126.5, 127.0], device=dev)
    x = torch.cat([ties, randn(CODEC_BLOCK + 300)])   # amax 127: scale 1, exact ties
    got = pack_ops.quantize_blocks(x, block_elems=CODEC_BLOCK)
    compare_pack(got, plain_quantize(x), "exact ties")
    if got[0][0, :7].tolist() != [70, -70, 0, 2, 2, -2, 126]:
        fail(f"ties not rounded half to even: {got[0][0, :7].tolist()}")
    # amax / 127 underflows to 0 in the first block (scale 1, q = 0: the host
    # codec's rule); the second block's scale is subnormal
    x = torch.zeros(2 * CODEC_BLOCK, device=dev)
    x[:3] = torch.tensor([4e-44, -7e-45, 1.4e-45])
    x[CODEC_BLOCK:CODEC_BLOCK + 3] = torch.tensor([2e-38, 1e-39, -5e-40])
    got = pack_ops.quantize_blocks(x, block_elems=CODEC_BLOCK)
    compare_pack(got, plain_quantize(x), "subnormal blocks")
    if got[1][0].item() != 1.0 or got[0][0].any().item():
        fail(f"an underflowing block got scale {got[1][0].item()}")
    mesh_n = MESH["nx"] * MESH["ny"] * MESH["nz"]
    field0 = SeismicField(SeismicConfig(**MESH), device=dev).step(0).float()
    for what, x in (("the seismic field, step 0", field0), ("normal values", randn(mesh_n))):
        pack_worst = max(pack_worst, compare_pack(
            pack_ops.quantize_blocks(x, block_elems=CODEC_BLOCK), plain_quantize(x),
            f"full mesh {MESH} ({mesh_n} values as "
            f"({-(-mesh_n // CODEC_BLOCK) * PACK_TILE[0]}, {PACK_TILE[1]}), tile "
            f"{PACK_TILE}), {what}"))
    int8_codec = Int8BlockCodec()
    payload, meta = int8_codec.encode(field0)            # the kernel, on the card
    host_payload, host_meta = int8_codec.encode(field0.cpu().numpy())   # numpy, host
    same_payload = bytes(memoryview(payload)) == host_payload and meta == host_meta
    log(f"int8-block payload of the full-mesh field from the card ({len(payload)} B) "
        f"equal to the numpy host path's byte for byte: {same_payload}; meta {meta}")
    if not same_payload:
        fail("the card's int8-block payload differs from the host path's")
    # float16 into the pack kernel: the card's payload against the numpy host
    # codec's (both widen to f32 before anything is computed)
    x16 = (randn(3 * CODEC_BLOCK + 17) * 9).to(torch.float16)
    launches_before = LAUNCHES["staging_pack"]
    payload16, meta16 = int8_codec.encode(x16)
    host16, host_meta16 = int8_codec.encode(x16.cpu().numpy())
    same16 = (bytes(memoryview(payload16)) == host16 and meta16 == host_meta16
              and LAUNCHES["staging_pack"] == launches_before + 1)
    log(f"int8-block payload of {x16.numel()} float16 values from the card "
        f"({len(payload16)} B, one pack launch) equal to the numpy host path's "
        f"byte for byte: {same16}; meta {meta16}")
    if not same16:
        fail("the card's float16 int8-block payload differs from the host path's")
    del x, got, payload, host_payload, x16
    log(f"kernel checks done at {time.perf_counter() - t_start:.1f} s")

    # -- 4. + 5. each cell: serve, then its kernel's timing ----------------------
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

    class Lockstep:
        """Serves the plain scan and runs the kernel beside it on each call's
        inputs (each mamba layer's prefill), so every layer's kernel output is
        held to the plain one on that layer's real input, however far the
        deep model has grown the residual stream; also reads mean |residual|
        after every prefill layer. Its kernel launches are comparisons."""

        def __init__(self):
            self.layers, self.residual = [], []
            self._block = transformer_mod.apply_block

        def scan(self, *inputs):
            y_p, h_p = ssm_scan_ref(*inputs)
            y_k, h_k = scan_ops.selective_scan(*inputs)
            self.layers.append(dict(
                y_equal=float((y_k == y_p).float().mean()),
                h_equal=float((h_k == h_p).float().mean()),
                y_max_err=float((y_k.float() - y_p.float()).abs().max()),
                y_mean_abs=float(y_p.float().abs().mean())))
            return y_p, h_p

        def block(self, kind, p, x, **kw):
            out, cache = self._block(kind, p, x, **kw)
            if x.shape[1] > 1:
                self.residual.append(float(out.abs().mean(dtype=torch.float32)))
            return out, cache

        @contextlib.contextmanager
        def swap(self):
            with swapped(ssm_mod, "selective_scan", self.scan), \
                    swapped(transformer_mod, "apply_block", self.block):
                yield

    class AttentionLockstep:
        """Serves the plain attention and runs the kernel beside it on each
        call's q, k, v (each gemma2 layer's prefill), holding the kernel to
        kernel_error_limit on the activations the model really serves. Its
        kernel launches are comparisons."""

        def __init__(self):
            self.layers = []

        def attention(self, q, k, v, **kw):
            o_p = ops.gqa_attention_ref(q, k, v, **kw)
            o_k = ops.gqa_attention(q, k, v, **kw)
            max_err, ratio, mean_ref = attention_error(q, k, v, o_k, **kw)
            self.layers.append(dict(window=kw.get("window", 0), max_err=max_err,
                                    err_over_limit=ratio, mean_abs_ref=mean_ref))
            return o_p

    def serve_cell(cell, plain_swap, plain_launches=None,
                   probe=None) -> tuple[dict, dict]:
        """Serve the cell through its kernel, then through the kernel's plain
        version (``plain_swap``; it launches ``plain_launches``, by default
        none), then warm, then ``probe(cfg, serve kwargs, first run)`` if
        given, whose readings join the stats. Returns (stats, launches of the
        first run)."""
        cfg = cell_config(cell)
        name = cell["kernel"]
        log(f"serve: {cfg.name} at published widths ({json.dumps(dataclasses.asdict(cfg))}); "
            f"reduced: {cell['reduced']}")
        kw = dict(batch=cell["batch"], prompt_len=cell["prompt_len"],
                  new_tokens=cell["new_tokens"], seed=cell["seed"], device=dev,
                  log=log)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        first = serve(cfg, **kw)
        launches = dict(LAUNCHES)
        log(f"serve launches: {launches}")
        want = {k: (cfg.n_layers if k == name else 0) for k in launches}
        if launches != want:
            fail(f"{cfg.name} serve path launched {launches}, want {want} "
                 f"(one {name} per layer's prefill)")
        params, prompts = first["params"], first["prompts"]
        B, N, V = cell["batch"], cell["new_tokens"], cfg.vocab_size
        lg = first["prefill_logits"]
        if lg.shape != (B, V) or not bool(torch.isfinite(lg).all()):
            fail(f"prefill logits {tuple(lg.shape)} not finite or misshaped")
        toks = first["tokens"]
        if toks.shape != (B, N) or int(toks.min()) < 0 or int(toks.max()) >= V:
            fail(f"generated tokens {tuple(toks.shape)} out of range")

        # the same model, params and prompts through the kernel's plain version
        with plain_swap:
            reset_launches()
            plain = serve(cfg, **kw, params=params, prompts=prompts)
        if LAUNCHES != (plain_launches or {k: 0 for k in launches}):
            fail(f"the plain run launched {dict(LAUNCHES)}")
        ref_lg = plain["prefill_logits"].float()
        logit_err = float((lg.float() - ref_lg).abs().max())
        logit_mean = float(ref_lg.abs().mean())
        agree = int((toks == plain["tokens"]).sum())
        log(f"serve: prefill logits kernel vs plain max|err| {logit_err:.3g}, "
            f"mean|logit| {logit_mean:.3g}, max|logit| "
            f"{float(ref_lg.abs().max()):.3g} (limit {LOGITS_REL}*mean|logit| = "
            f"{LOGITS_REL * logit_mean:.3g}); greedy tokens agreeing "
            f"{agree}/{B * N}")
        if not logit_err <= LOGITS_REL * logit_mean:
            fail("prefill logits of the kernel path disagree with the plain path")
        peak_all = torch.cuda.max_memory_allocated() / 1e9

        # a second kernel-path run, warm, for the serve times
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        timed = serve(cfg, **kw, params=params, prompts=prompts)
        if LAUNCHES != want:
            fail(f"timed run launched {dict(LAUNCHES)}, want {want}")
        lat = np.asarray(timed["decode_ms"])
        stats = {
            "config": f"{cfg.name} n_layers={cfg.n_layers}",
            "prefill_ms": timed["prefill_ms"], "plain_prefill_ms": plain["prefill_ms"],
            "decode_p50_ms": float(np.percentile(lat, 50)),
            "decode_p99_ms": float(np.percentile(lat, 99)),
            "logits_max_abs_err": logit_err, "logits_mean_abs": logit_mean,
            "tokens_agree": agree, "tokens": B * N,
            "peak_mem_gb": peak_all,
            "warm_run_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"serve (warm): {json.dumps(stats)}")
        if probe is not None:
            stats.update(probe(cfg, kw, first))
        return stats, launches

    serve_stats = {}
    # gemma2-27b: flash attention
    gcfg = cell_config(SERVE)
    attn_lockstep = AttentionLockstep()
    serve_stats[SERVE["arch"]], fa_launches = serve_cell(
        SERVE, swapped(attention_mod, "gqa_attention", attn_lockstep.attention),
        {"flash_attention": gcfg.n_layers, "ssm_scan": 0, "staging_pack": 0})
    torch.cuda.empty_cache()
    att = attn_lockstep.layers
    log("lockstep (gemma2-27b prefill, the kernel on each layer's served q, k, v): "
        + "; ".join(f"layer {i + 1} (window {a['window']}): max|err| "
                    f"{a['max_err']:.3g}, mean|ref| {a['mean_abs_ref']:.3g}, "
                    f"max |err|/limit {a['err_over_limit']:.3f}"
                    for i, a in enumerate(att)) + " (limit 1)")
    if len(att) != gcfg.n_layers or any(not a["err_over_limit"] <= 1 for a in att):
        fail(f"flash_attention disagrees with its plain version on a served "
             f"layer's input ({len(att)} layers seen, want {gcfg.n_layers})")
    serve_stats[SERVE["arch"]]["lockstep"] = att

    Bs, S = SERVE["batch"], SERVE["prompt_len"]
    g = GEMMA_SHAPE
    window_local = cell_config(SERVE).attn_window
    q, k, v = qkv(Bs, S, S, g["Hq"], g["Hkv"], g["D"], torch.bfloat16)
    t = {}
    probe_ratio = {}
    for name, window in (("local", window_local), ("global", 0)):
        akw = dict(scale=g["scale"], softcap=g["cap"], causal=True, window=window)
        err, mean_ref = compare(q, k, v, f"serve shape B={Bs} S={S} ({name})",
                                **akw)
        probe_ratio[name] = probe(Bs, S, g["Hq"], g["Hkv"], g["D"],
                                  f"serve shape B={Bs} S={S} ({name})", **akw)
        worst["serve_shape"] = max(worst.get("serve_shape", 0.0), err)
        t[name] = dict(
            ms=time_ms(lambda: ops.gqa_attention(q, k, v, **akw)),
            plain_ms=time_ms(lambda: ops.gqa_attention_ref(q, k, v, **akw)),
            bound=attention_bound_ms(Bs, S, g["Hq"], g["Hkv"], g["D"], True,
                                     window, "bfloat16"))
        log(f"time {name} (window {window}, cap {g['cap']}): kernel "
            f"{t[name]['ms']:.3f} ms, plain {t[name]['plain_ms']:.3f} ms, bound "
            f"{t[name]['bound'][0]:.3f} ms ({t[name]['bound'][1]})")
    # the library yardstick: SDPA has no softcap, so kernel and SDPA at cap 0;
    # cap 50 against cap 0 is what the softcap costs the kernel
    nocap = dict(scale=g["scale"], softcap=0.0, causal=True, window=0)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      scale=g["scale"], enable_gqa=True))
    cap0_ms = time_ms(lambda: ops.gqa_attention(q, k, v, **nocap))
    cap0_local_ms = time_ms(lambda: ops.gqa_attention(
        q, k, v, **dict(nocap, window=window_local)))
    log(f"time cap 0: kernel {cap0_ms:.3f} ms global, {cap0_local_ms:.3f} ms "
        f"local; scaled_dot_product_attention (global) {library_ms} ms; the "
        f"softcap costs {t['global']['ms'] - cap0_ms:.3f} ms global, "
        f"{t['local']['ms'] - cap0_local_ms:.3f} ms local")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    log(f"gemma2-27b cell done at {time.perf_counter() - t_start:.1f} s")

    def nudge_probe(cfg, kw, first) -> dict:
        """A reading, not a check: how far the served logits move when every
        layer's scan output is one bf16 step off in every NUDGE_EVERY-th
        element, as a kernel that rounds differently would leave it. This is
        what the cell's logits gate asks of a scan kernel."""
        def nudged(*inputs):
            y, h = scan_ops.selective_scan(*inputs)
            if y.dtype != torch.bfloat16:
                fail(f"nudge probe wants a bf16 y, got {y.dtype}")
            y.view(-1).view(torch.int16)[::NUDGE_EVERY] += 1   # one step
            return y, h

        with swapped(ssm_mod, "selective_scan", nudged):
            out = serve(cfg, **kw, params=first["params"], prompts=first["prompts"])
        lg, lg_n = first["prefill_logits"].float(), out["prefill_logits"].float()
        err = float((lg_n - lg).abs().max())
        agree = int((out["tokens"] == first["tokens"]).sum())
        log(f"nudge probe: one bf16 step in every {NUDGE_EVERY}th scan output "
            f"of every layer moves the prefill logits by max|err| {err:.3g} "
            f"against mean|logit| {float(lg.abs().mean()):.3g} (the gate: "
            f"{LOGITS_REL}*mean|logit|); greedy tokens agreeing "
            f"{agree}/{out['tokens'].numel()}")
        return {"nudge_logits_max_abs_err": err, "nudge_tokens_agree": agree}

    # falcon-mamba-7b: the selective scan, lockstep in the plain-scan run
    lockstep = Lockstep()
    serve_stats[SERVE_MAMBA["arch"]], scan_launches = serve_cell(
        SERVE_MAMBA, lockstep.swap(),
        {"flash_attention": 0, "ssm_scan": mcfg.n_layers, "staging_pack": 0},
        nudge_probe)
    torch.cuda.empty_cache()
    steps = lockstep.layers
    if len(steps) != mcfg.n_layers or len(lockstep.residual) != mcfg.n_layers:
        fail(f"lockstep saw {len(steps)} scans and {len(lockstep.residual)} "
             f"layers, want {mcfg.n_layers}")
    res = lockstep.residual
    log("lockstep: mean|residual| after layer " + ", ".join(
        f"{i + 1}: {res[i]:.3g}" for i in range(len(res))
        if i in (0, 1, 3, len(res) - 1) or (i + 1) % 8 == 0))
    log(f"lockstep: kernel y equal to the plain y in every element in "
        f"{sum(s['y_equal'] == 1.0 for s in steps)}/{len(steps)} layers, h_last "
        f"in {sum(s['h_equal'] == 1.0 for s in steps)}/{len(steps)} (limit: all); "
        f"least share equal {min(s['y_equal'] for s in steps)}, max|err| "
        f"{max(s['y_max_err'] for s in steps):.3g}; mean|y| from "
        f"{min(s['y_mean_abs'] for s in steps):.3g} to "
        f"{max(s['y_mean_abs'] for s in steps):.3g}")
    if any(s["y_equal"] != 1.0 or s["h_equal"] != 1.0 for s in steps):
        fail("ssm_scan disagrees with its plain version on a served layer's input")
    serve_stats[SERVE_MAMBA["arch"]]["lockstep"] = {
        "residual_mean_abs": res, "y_equal_min": min(s["y_equal"] for s in steps),
        "y_max_err": max(s["y_max_err"] for s in steps)}

    ss = scan_shape
    dt_rank = mcfg.ssm.resolved_dt_rank(mcfg.d_model)
    sin = scan_inputs(ss["B"], ss["S"], ss["di"], ss["N"], *mixed, dt_rank=dt_rank)
    scan_err, scan_mean_ref = compare_scan(sin, f"serve shape {ss}")
    scan_ms = time_ms(lambda: scan_ops.selective_scan(*sin), reps=10)
    scan_plain_ms = time_ms(lambda: ssm_scan_ref(*sin), reps=2)
    y_out, h_out = scan_ops.selective_scan(*sin)
    scan_bound, scan_bound_by, scan_detail = scan_bound_ms(sin, (y_out, h_out))
    log(f"time ssm_scan {ss} (xi bf16, dt f32, B/C bf16): kernel {scan_ms:.3f} ms, "
        f"plain {scan_plain_ms:.3f} ms, bound {scan_bound:.3f} ms "
        f"({scan_bound_by}; {json.dumps(scan_detail)})")
    del sin, y_out, h_out
    torch.cuda.empty_cache()

    # -- 6. in transit: the paper's producer path at its mesh --------------------
    from repro_torch.analysis import AnalysisSession, analyzers, tar
    from repro_torch.core import (InTransitConfig, InTransitSink, SavimeServer,
                                  StagingServer)
    mem_capacity = min(MAX_STAGING_MEM, int(shm_free_bytes() * SHM_SHARE))
    disk_dir = ROOT / "build" / "staging-disk"     # the overflow tier, in the checkout
    log(f"staging memory tier: {mem_capacity} B of /dev/shm; overflow to {disk_dir}")
    raw_step = mesh_n * 4
    nb_mesh = -(-mesh_n // CODEC_BLOCK)

    def intransit(codec: str) -> dict:
        """Stage INTRANSIT_STEPS steps of the mesh through the port's sink,
        staging and SAVIME, flushing each, while an analyst thread reacts to
        each arrival with a range query of that step (the example's window
        energy). Checks what landed; returns the readings."""
        sim = SeismicField(SeismicConfig(**MESH), device=dev)
        savime = SavimeServer().start()
        staging = StagingServer(savime.addr, mem_capacity=mem_capacity,
                                disk_dir=str(disk_dir), send_threads=2).start()
        rows, analyst_errors, stop = [], [], threading.Event()

        def analyst():
            try:
                with AnalysisSession(savime.addr) as an:
                    energy = analyzers.create("window_reduce", window=4, op="mean",
                                              step_op="sum")
                    with an.watch("sim_velocity") as sub:
                        while not stop.is_set():
                            ev = sub.poll(0.1)
                            if ev is None:
                                continue
                            box = an.execute(tar("sim_velocity").attr("v")
                                             .range(ev.origin, ev.hi).select())
                            sq = box.array.astype(np.float64) ** 2
                            energy.update(sq)
                            rows.append((ev.origin[0], float(sq.sum())))
            except Exception as e:  # noqa: BLE001 — reported and failed below
                analyst_errors.append(repr(e))

        watcher = threading.Thread(target=analyst, name="analyst", daemon=True)
        watcher.start()
        try:
            sink = InTransitSink(staging.addr, InTransitConfig(
                io_threads=2, tar_prefix="sim", max_inflight_bytes=256 << 20,
                codec=codec, decode_at="staging"))
            steps = []
            try:
                torch.cuda.synchronize()
                reset_launches()
                t_run = time.perf_counter()
                for step in range(INTRANSIT_STEPS):
                    t0 = time.perf_counter()
                    field = sim.step(step).float()
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    sink.stage_array("velocity", field, step=step)
                    t2 = time.perf_counter()
                    sink.session.sync(timeout=600)     # the first part of flush
                    t_sync = time.perf_counter()
                    sink.flush(timeout=600)
                    t3 = time.perf_counter()
                    steps.append(dict(generate_ms=(t1 - t0) * 1e3,
                                      stage_ms=(t2 - t1) * 1e3,
                                      flush_ms=(t3 - t2) * 1e3,
                                      flush_sync_ms=(t_sync - t2) * 1e3))
                    log(f"in transit [{codec}] step {step}: generate "
                        f"{steps[-1]['generate_ms']:.1f} ms, blocked in stage_array "
                        f"{steps[-1]['stage_ms']:.1f} ms, flush "
                        f"{steps[-1]['flush_ms']:.1f} ms (of which "
                        f"{steps[-1]['flush_sync_ms']:.1f} ms until staging holds "
                        f"the step; the rest until SAVIME does); "
                        f"{raw_step / 1e6 / (t3 - t0):.1f} raw MB/s end to end")
                run_s = time.perf_counter() - t_run
                launches = dict(LAUNCHES)
                codec_stats = dict(sink.session.stats.codec)
            finally:
                sink.close()
            time.sleep(0.3)                    # the last events reach the analyst
            stop.set()
            watcher.join(timeout=60)
            if watcher.is_alive() or analyst_errors:
                fail(f"in transit [{codec}]: the analyst failed: {analyst_errors}")
            last = INTRANSIT_STEPS - 1
            with AnalysisSession(savime.addr) as an:
                back = an.execute(tar("sim_velocity").attr("v").range(
                    (last, 0, 0, 0), (last, MESH["nx"] - 1, MESH["ny"] - 1,
                                      MESH["nz"] - 1)).select()).array
            box = savime.engine.tars["sim_velocity"].data_box()
            staging_stats = dict(staging.stats)
        finally:
            staging.stop()
            savime.stop()
        log(f"in transit [{codec}]: launches {launches}; codec {codec_stats}; "
            f"staging {json.dumps({k: staging_stats[k] for k in ('datasets', 'bytes_in', 'raw_bytes_in', 'disk_fallbacks', 'codec_datasets')})}; "
            f"SAVIME holds steps {box[0][0]}..{box[1][0]}; the analyst saw "
            f"{len(rows)} arrivals")
        want_launches = {k: (INTRANSIT_STEPS if k == "staging_pack" and codec == "int8-block"
                             else 0) for k in launches}
        if launches != want_launches:
            fail(f"in transit [{codec}] launched {launches}, want {want_launches}")
        if box != ((0, 0, 0, 0), (last, MESH["nx"] - 1, MESH["ny"] - 1, MESH["nz"] - 1)):
            fail(f"in transit [{codec}]: SAVIME holds {box}")
        if not rows:
            fail(f"in transit [{codec}]: the analyst saw no arrival")
        back = back.reshape(-1)
        if codec == "int8-block":
            if codec_stats.get("fallbacks") != 0 or codec_stats.get("datasets") != INTRANSIT_STEPS:
                fail(f"int8-block codec fell back or skipped a step: {codec_stats}")
            want_wire = INTRANSIT_STEPS * (mesh_n + 4 * nb_mesh)
            if codec_stats["wire_bytes"] != want_wire or \
                    codec_stats["raw_bytes"] != INTRANSIT_STEPS * raw_step:
                fail(f"wire/raw bytes {codec_stats}, want {want_wire}/"
                     f"{INTRANSIT_STEPS * raw_step}")
            host = Int8BlockCodec()
            want = host.decode(*host.encode(field.cpu().numpy())).view(np.float32)
            equal = back.tobytes() == want.tobytes()
            x = field.reshape(-1).double()
            dq = torch.from_numpy(back).to(dev).double()
            _, s = pack_ops.quantize_blocks(field, block_elems=CODEC_BLOCK)
            amax = torch.nn.functional.pad(x.abs(), (0, nb_mesh * CODEC_BLOCK - mesh_n)
                                           ).reshape(nb_mesh, CODEC_BLOCK).amax(1)
            normal = s >= torch.finfo(torch.float32).tiny

            def per_element(v):
                return v.repeat_interleave(CODEC_BLOCK)[:mesh_n]

            # q = rint(fl(x/s)), dq = fl(q*s): where s is a normal float,
            # |x - dq| <= s/2 + 2^-24 (|x| + |q s|) <= s/2 + 2^-23 |x| + 2^-25 s
            # (the f32 rounding of the quotient and the product). A subnormal
            # s (amax < 127 * 2^-126) is amax/127 rounded to few bits, so
            # |x / s| may pass 127 and clip: there |x - dq| <= amax.
            s_el = per_element(s.double())
            err = (x - dq).abs()
            bound = torch.where(per_element(normal),
                                s_el / 2 + 2.0 ** -23 * x.abs() + 2.0 ** -25 * s_el,
                                per_element(amax))
            within = bool((err <= bound).all())
            log(f"in transit [int8-block]: step {last} read back equal to the host "
                f"codec's decode byte for byte: {equal}; max|field - read back| "
                f"{float(err.max()):.4g}, max of it over its bound (scale/2 + f32 "
                f"rounding; the block's amax in the {int((~normal).sum())} of "
                f"{nb_mesh} blocks whose scale is subnormal) "
                f"{float((err / bound).max()):.4f} (limit 1); wire/raw "
                f"{codec_stats['wire_bytes'] / codec_stats['raw_bytes']:.6f}")
            if not (equal and within):
                fail("the int8-block step read back differs from the host decode "
                     "or exceeds the quantization bound")
        elif back.tobytes() != field.cpu().numpy().tobytes():
            fail(f"in transit [{codec}]: step {last} read back differs from the field")
        ms = {k: [s_[k] for s_ in steps] for k in steps[0]}
        return {"launches": launches["staging_pack"], "steps": INTRANSIT_STEPS,
                "raw_mb_per_step": raw_step / 1e6, "run_s": run_s,
                "raw_mb_per_s": INTRANSIT_STEPS * raw_step / 1e6 / run_s,
                **{f"{k}_median": float(np.median(v)) for k, v in ms.items()},
                "per_step_ms": ms, "codec": codec_stats,
                "staging_disk_fallbacks": staging_stats["disk_fallbacks"],
                "analyst_arrivals": len(rows)}

    intransit_stats = {}
    for codec in ("int8-block", "none"):
        intransit_stats[codec] = intransit(codec)
        torch.cuda.empty_cache()
    log(f"in transit: {json.dumps({c: {k: v for k, v in s.items() if k != 'per_step_ms'} for c, s in intransit_stats.items()})}")

    def intransit_bf16(codec: str) -> dict:
        """One step of the mesh in bfloat16 through the port's sink, staging
        and SAVIME (numpy has no bfloat16 here: the port holds its bits as
        uint16). SAVIME must hold 2 bytes a value under attribute type
        "bfloat16": with int8-block the decode of the card's pack, equal to
        the same codec's encode and decode on the host; with none the
        values' own bits. A query gives them back widened to float32."""
        from repro_torch.tensors import bf16_to_f32, to_host
        field = SeismicField(SeismicConfig(**MESH), device=dev).step(0).to(torch.bfloat16)
        savime = SavimeServer().start()
        staging = StagingServer(savime.addr, mem_capacity=mem_capacity,
                                disk_dir=str(disk_dir), send_threads=2).start()
        try:
            sink = InTransitSink(staging.addr, InTransitConfig(
                io_threads=2, tar_prefix="bf", codec=codec, decode_at="staging"))
            try:
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                sink.stage_array("velocity", field, step=0)
                sink.flush(timeout=600)
                step_ms = (time.perf_counter() - t0) * 1e3
                launches = dict(LAUNCHES)
            finally:
                sink.close()
            held_tar = savime.engine.tars["bf_velocity"]
            held = held_tar.select("v").reshape(-1)
            with AnalysisSession(savime.addr) as an:
                got = an.execute(tar("bf_velocity").attr("v").select()).array.reshape(-1)
        finally:
            staging.stop()
            savime.stop()
        if codec == "int8-block":
            host = Int8BlockCodec()
            want = host.decode(*host.encode(field.cpu())).view(np.uint16)
        else:
            want = to_host(field).reshape(-1)
        equal = held.dtype == np.uint16 and held.tobytes() == want.tobytes()
        widened = got.dtype == np.float32 and np.array_equal(got, bf16_to_f32(want))
        err = float(np.abs(bf16_to_f32(held) - field.float().cpu().numpy().reshape(-1)).max())
        log(f"in transit bf16 [{codec}]: one {MESH} step staged and flushed in "
            f"{step_ms:.1f} ms; launches {launches}; SAVIME attribute type "
            f"{held_tar.attrs['v'].dtype!r}, {held.nbytes} B held ({held.dtype}); "
            f"equal to the host codec's decode (int8-block) or the values' bits "
            f"(none) byte for byte: {equal}; query widened to float32 exactly: "
            f"{widened}; max|field - held| {err:.4g}")
        want_launches = {k: int(k == "staging_pack" and codec == "int8-block")
                         for k in launches}
        if not (equal and widened and launches == want_launches
                and held_tar.attrs["v"].dtype == "bfloat16"
                and held.nbytes == 2 * mesh_n):
            fail(f"in transit bf16 [{codec}]: SAVIME does not hold what was staged")
        return {"launches": launches["staging_pack"], "step_ms": step_ms,
                "max_abs_err": err}

    for codec in ("int8-block", "none"):
        intransit_stats[f"bf16 {codec}"] = intransit_bf16(codec)
        torch.cuda.empty_cache()

    # -- 7. the pack kernel's time at the mesh -----------------------------------
    x = SeismicField(SeismicConfig(**MESH), device=dev).step(INTRANSIT_STEPS - 1).float()
    pack_err = compare_pack(pack_ops.quantize_blocks(x, block_elems=CODEC_BLOCK),
                            plain_quantize(x), "full mesh, timed input")
    pack_ms = time_ms(lambda: pack_ops.quantize_blocks(x, block_elems=CODEC_BLOCK), reps=50)
    pack_plain_ms = time_ms(lambda: plain_quantize(x), reps=5)
    # the field's far tails are subnormal floats, which take the slow path of
    # the IEEE division: the same call on normal values, for comparison
    x_normal = randn(mesh_n)
    pack_normal_ms = time_ms(lambda: pack_ops.quantize_blocks(x_normal,
                                                              block_elems=CODEC_BLOCK),
                             reps=50)
    subnormal_share = float(((x != 0) & (x.abs() < torch.finfo(torch.float32).tiny))
                            .float().mean())
    del x_normal
    q_out, s_out = pack_ops.quantize_blocks(x, block_elems=CODEC_BLOCK)
    pack_bound, pack_bound_by, pack_detail = pack_bound_ms(x, q_out, s_out)
    # the non-quantizing re-tile, where PyTorch has a call: the kernel's cast
    # path against permute().contiguous() on the padded (R, 128) array
    xp = torch.nn.functional.pad(x.reshape(-1), (0, nb_mesh * CODEC_BLOCK - mesh_n)
                                 ).reshape(-1, PACK_TILE[1])
    ni, nj = xp.shape[0] // PACK_TILE[0], xp.shape[1] // PACK_TILE[1]
    retile_ms = time_ms(lambda: pack_kernel.pack_blocks(xp, tile=PACK_TILE), reps=50)
    # with one tile column the permuted view is already contiguous, so the
    # library call is the copy that materializes it
    retile_library_ms = time_ms(lambda: xp.view(ni, PACK_TILE[0], nj, PACK_TILE[1])
                                .permute(0, 2, 1, 3).reshape(ni * nj, -1).clone(),
                                reps=50)
    log(f"time staging_pack at the mesh ({mesh_n} f32 values of the seismic field, "
        f"{subnormal_share:.4f} of them subnormal; tile {PACK_TILE}, int8): kernel "
        f"{pack_ms:.4f} ms (on normal values {pack_normal_ms:.4f} ms), plain "
        f"{pack_plain_ms:.3f} ms, bound {pack_bound:.4f} ms ({pack_bound_by}; "
        f"{json.dumps(pack_detail)}); re-tile without quantize: kernel "
        f"{retile_ms:.4f} ms, permute().reshape().clone() {retile_library_ms:.4f} ms")
    del x, xp, q_out, s_out, field0

    summary = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
        "launches": fa_launches["flash_attention"],
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
        "ms_cap0_local": cap0_local_ms,
        "sass_hgmma": hgmma,
        "mask_probe_err_over_limit": probe_ratio,
        "lockstep_err_over_limit": [a["err_over_limit"] for a in att],
        "ms_local": t["local"]["ms"],
        "plain_ms_local": t["local"]["plain_ms"],
        "bound_ms_local": t["local"]["bound"][0],
        "max_abs_err_cases": worst,
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:51",
        "launches": scan_launches["ssm_scan"],
        "shape": (f"B={ss['B']} S={ss['S']} di={ss['di']} N={ss['N']} xi/B/C "
                  f"bf16, dt/A/h0 f32 (every falcon-mamba-7b layer's prefill)"),
        "max_abs_err": scan_err,
        "mean_abs_ref": scan_mean_ref,
        "ms": scan_ms,
        "plain_ms": scan_plain_ms,
        "bound_ms": scan_bound,
        "bound_by": scan_bound_by,
        "bound_detail": scan_detail,
        "library_ms": None,
        "library_call": "none: no PyTorch call computes a selective scan",
        "max_abs_err_cases": scan_worst,
    }, {
        "name": "staging_pack",
        "route": "cuda",
        "source": "src/repro_torch/kernels/staging_pack/csrc/staging_pack.cu",
        "replaces": "src/repro/kernels/staging_pack/kernel.py:37",
        "launches": intransit_stats["int8-block"]["launches"],
        "shape": (f"{mesh_n} f32 values ({MESH['nx']}x{MESH['ny']}x{MESH['nz']} mesh) "
                  f"as ({nb_mesh * PACK_TILE[0]}, {PACK_TILE[1]}), tile {PACK_TILE}, "
                  f"int8 out (every in-transit step with codec int8-block)"),
        "max_abs_err": pack_err,
        "max_abs_err_cases": pack_worst,
        "ms": pack_ms,
        "plain_ms": pack_plain_ms,
        "bound_ms": pack_bound,
        "bound_by": pack_bound_by,
        "bound_detail": pack_detail,
        "library_ms": None,
        "library_call": "none: no PyTorch call computes a per-block int8 quantize",
        "ms_retile": retile_ms,
        "library_ms_retile": retile_library_ms,
        "library_call_retile": "x.view(ni,TR,nj,TC).permute(0,2,1,3).reshape(ni*nj,-1).clone()",
        "ms_normal_values": pack_normal_ms,
        "subnormal_share": subnormal_share,
    }], "serve": serve_stats, "intransit": intransit_stats}
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
