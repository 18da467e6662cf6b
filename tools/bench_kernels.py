#!/usr/bin/env python3
"""Time the selective-scan, pack, flash-attention and decode-attention
kernels on one GPU, at the shapes the port's paths give them.

    python3 tools/bench_kernels.py [--src DIR] [--reps N] [--kernels scan,pack,flash,decode]

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
    values;
  * flash: bf16, B=4 S=4600: gemma2-27b's global and local layers (Hq 32,
    Hkv 16, D 128, window 4096) at softcap 50 and 0; where the version
    takes head dim 256 and a prefix, recurrentgemma-9b's local layer (Hq 16,
    Hkv 1, window 2048) and paligemma-3b's (Hq 8, Hkv 1, prefix 256). Each
    is held to ``kernel_error_limit`` against the plain version first;
  * decode: the ``qwen2-72b.batch-decode`` cell's attention layer, bf16:
    B=256 rows into 2,304-slot caches, in 8 groups of 32 at positions
    staggered as the cell's (group g at 256 + (g + 1/2) * 256, a group's
    rows 0..31 steps apart), GQA 64/8, head dim 128; held to its plain
    version first (per element 2**-7 max|v|), and timed beside its bound
    (the bytes each row needs, K and V up to its position, over 3.35 TB/s),
    its plain version and one PyTorch call (SDPA with the mask). The caches
    (2.4 GB) are far larger than the L2. Then, at the launcher's split of
    the slot axis and at one split, that layer and two of few rows:
    gemma2-27b's served global layer (B=4 at position 4630 of 4632 slots,
    GQA 32/16, softcap 50) and one row at the end of a 32k chat at
    qwen2-72b's widths (T 32,768), each held to the same limit first.
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
FLASH_SHAPES = {  # name: (Hq, Hkv, D, scale, softcap, window, prefix)
    "gemma2_global": (32, 16, 128, 144 ** -0.5, 50.0, 0, 0),
    "gemma2_local": (32, 16, 128, 144 ** -0.5, 50.0, 4096, 0),
    "gemma2_global_cap0": (32, 16, 128, 144 ** -0.5, 0.0, 0, 0),
    "gemma2_local_cap0": (32, 16, 128, 144 ** -0.5, 0.0, 4096, 0),
    "rglru_local_d256": (16, 1, 256, 256 ** -0.5, 0.0, 2048, 0),
    "paligemma_prefix_d256": (8, 1, 256, 256 ** -0.5, 0.0, 0, 256),
}
MESH = dict(nx=201, ny=501, nz=501)
BLOCK = 4096
DECODE_SHAPE = dict(B=256, T=2304, Hq=64, Hkv=8, D=128, groups=8, prompt=256, answer=2048)
# name: (B, T, Hq, Hkv, D, softcap, the rows' positions), timed at the
# launcher's split and at one split
DECODE_SPLIT_SHAPES = {"serve": (4, 4632, 32, 16, 128, 50.0, [4630] * 4),
                       "chat32k": (1, 32768, 64, 8, 128, 0.0, [32767])}
HBM_BYTES_PER_S = 3.35e12


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="scan,pack",
                    help="comma-separated: which of scan, pack, flash, decode to time")
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
    if "flash" in kernels:
        flash(out, randn, time_ms)
    if "decode" in kernels:
        decode(out, randn, time_ms, dev)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    if not all(v for k, v in out.items() if k.endswith(("_equal", "_within_limit"))):
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


def flash(out, randn, time_ms) -> None:
    import inspect

    import torch
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    takes_prefix = "prefix" in inspect.signature(ops.gqa_attention).parameters
    B, S = 4, 4600
    for name, (Hq, Hkv, D, scale, cap, window, prefix) in FLASH_SHAPES.items():
        if D not in kernel.HEAD_DIMS or (prefix and not takes_prefix):
            continue
        q = randn(B, S, Hq, D).to(torch.bfloat16)
        k, v = (randn(B, S, Hkv, D).to(torch.bfloat16) for _ in range(2))
        kw = dict(scale=scale, softcap=cap, causal=True, window=window)
        if prefix:
            kw["prefix"] = prefix
        o = ops.gqa_attention(q, k, v, **kw)
        o_p = ops.gqa_attention_ref(q.float(), k.float(), v.float(), **kw)
        pv = ops.gqa_attention_ref(q.float(), k.float(), v.float().abs(), **kw)
        lim = ref.kernel_error_limit(o_p, pv, dtype=torch.bfloat16)
        out[f"flash_{name}_within_limit"] = bool(((o.float() - o_p).abs() <= lim).all())
        del o, o_p, pv, lim
        out[f"flash_{name}_ms"] = time_ms(lambda: ops.gqa_attention(q, k, v, **kw))
        del q, k, v
        torch.cuda.empty_cache()


def decode(out, randn, time_ms, dev) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel, ref
    s = DECODE_SHAPE
    B, T, Hq, Hkv, D = s["B"], s["T"], s["Hq"], s["Hkv"], s["D"]
    per = B // s["groups"]
    pos = torch.tensor([s["prompt"] + int((g + 0.5) * s["answer"] / s["groups"]) + i
                        for g in range(s["groups"]) for i in range(per)],
                       dtype=torch.int32, device=dev)
    q = randn(B, 1, Hq, D).to(torch.bfloat16)
    k, v = (randn(B, T, Hkv * D).to(torch.bfloat16).view(B, T, Hkv, D) for _ in range(2))
    t = torch.arange(T, device=dev, dtype=torch.int32)
    cp = torch.where(t[None] <= pos[:, None], t[None], -1).to(torch.int32)
    kw = dict(pos=pos, cache_positions=cp, scale=D ** -0.5, cap=0.0)
    want = ref.decode_attention(q, k, v, **kw).float()
    limit = 2.0 ** -7 * float(v.float().abs().max())
    o = kernel.decode_attention(q, k, v, **kw)
    out["decode_within_limit"] = float((o.float() - want).abs().max()) <= limit
    out["decode_ms"] = time_ms(lambda: kernel.decode_attention(q, k, v, **kw))
    n = int((pos.long() + 1).clamp(max=T).sum())
    out["decode_bound_ms"] = (n * (2 * Hkv * D * 2 + 4) + 2 * B * Hq * D * 2) \
        / HBM_BYTES_PER_S * 1e3
    out["decode_plain_ms"] = time_ms(lambda: ref.decode_attention(q, k, v, **kw))
    mask = (cp >= 0) & (cp <= pos[:, None])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None, None],
                                              scale=kw["scale"], enable_gqa=True)
    out["decode_sdpa_within_limit"] = \
        float((sdpa().transpose(1, 2).float() - want).abs().max()) <= limit
    out["decode_library_ms"] = time_ms(sdpa)
    del k, v, cp, mask, kt, vt
    torch.cuda.empty_cache()
    for name, (B, T, Hq, Hkv, D, cap, at) in DECODE_SPLIT_SHAPES.items():
        pos = torch.tensor(at, dtype=torch.int32, device=dev)
        q = randn(B, 1, Hq, D).to(torch.bfloat16)
        k, v = (randn(B, T, Hkv * D).to(torch.bfloat16).view(B, T, Hkv, D)
                for _ in range(2))
        t = torch.arange(T, device=dev, dtype=torch.int32)
        cp = torch.where(t[None] <= pos[:, None], t[None], -1).to(torch.int32)
        kw = dict(pos=pos, cache_positions=cp, scale=D ** -0.5, cap=cap)
        want = ref.decode_attention(q, k, v, **kw).float()
        limit = 2.0 ** -7 * float(v.float().abs().max())
        splits, chunk = kernel._card_plan(dev, B, T, Hkv, Hq // Hkv, D, q.dtype)
        one = torch.empty_like(q)

        def one_split():
            kernel._launch(q, k, v, pos, cp, one, scale=kw["scale"], cap=cap,
                           window=0, seq_index=0, partial=False, splits=1,
                           chunk=-(-T // kernel.ROUND) * kernel.ROUND)
        one_split()
        o = kernel.decode_attention(q, k, v, **kw)
        out[f"decode_{name}_within_limit"] = max(
            float((o.float() - want).abs().max()),
            float((one.float() - want).abs().max())) <= limit
        out[f"decode_{name}_splits"] = splits
        out[f"decode_{name}_ms"] = time_ms(lambda: kernel.decode_attention(q, k, v, **kw))
        out[f"decode_{name}_one_split_ms"] = time_ms(one_split)
        n = int((pos.long() + 1).clamp(max=T).sum())
        out[f"decode_{name}_bound_ms"] = (n * (2 * Hkv * D * 2 + 4) + 2 * B * Hq * D * 2) \
            / HBM_BYTES_PER_S * 1e3
        del q, k, v, cp, want, one, o
        torch.cuda.empty_cache()
    splits, _ = kernel._card_plan(dev, s["B"], s["T"], s["Hkv"], s["Hq"] // s["Hkv"],
                                  s["D"], torch.bfloat16)
    out["decode_splits"] = splits


if __name__ == "__main__":
    main()
