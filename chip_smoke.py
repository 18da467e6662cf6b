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
     its falcon-mamba-7b prefill shape is checked in phase 5); flash
     attention also at head dim 256 (f32 and bf16) and at the phase-10
     cells' attention shapes, the prefix-LM mask included; before them,
     the SASS of every tensor-core instance of the flash-attention library
     (head dims 64, 128, 256) must hold HGMMA (wgmma) ops, and the head-dim
     256 instances' registers, spills, shared memory and blocks an SM are
     printed;
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
     share, reads how far its logits gate lets a kernel's rounding stray.
     Every cell's plain run (phase 10's too) decodes through the plain
     decode attention, the decode kernel beside it on each attention
     layer's served q and caches, held to ``decode_error_limit`` there;
     the first run must launch the decode kernel once an attention layer a
     decode step;
  5. timing: each kernel, checked once more against its plain version
     (flash attention also by the mask probe, local and global), then timed
     with its plain version, its bound and the library call that computes
     the same function (where there is one), at the shapes the serve path
     gives it; (5b) the decode-attention kernel at ``DECODE_SHAPES`` (every
     served cell's decode, the qwen2-72b.batch-decode cell's layer and a
     32k chat's row) against its plain version, at the launcher's split of
     the slot axis and at one split, each timed beside its plain version,
     its bound and scaled_dot_product_attention with the mask;
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
     the host codec's decode (int8-block) or to its bits (none);
  7. the pack kernel's time at that mesh: checked once more against its
     plain version, then timed with it, on normal values, against its bound
     and beside the library's non-quantizing re-tile;
  8. train: (a) gemma2-27b at published widths with its depth cut to 2
     layers (``TRAIN``), ``remat="full"``, bf16 compute on f32 params, 4
     steps of AdamW at global batch 2 x 4600 tokens in 2 microbatches,
     ``egress="grads_int8"``, each step's diagnostics, int8 gradient blocks
     and scales staged through the port's sink, staging and SAVIME. Before
     the run, step 1's loss and gradients (step 0's LR is 0, so step 1 sees
     the initial params) are computed once through the kernel and once
     through the plain attention (autograd through the whole plain
     version), and held to the gates below. The run's launches, finite
     losses and SAVIME's read-back are checked; the step time, peak memory,
     the flash kernel's time, the plain attention backward's time and the
     AdamW update's time (CUDA events) are printed. (b) recovery: the
     example ``examples/torch_train_with_intransit.py`` on the card at the
     gemma2-27b smoke config with its own settings (200 steps, one failure
     injected at step 100), in this process, with its launches counted;
  9. the paper's transports from the card (``transports_from_the_card``):
     each step of the mesh made on the card by ``SeismicField`` and staged
     through the port's sink, read back from SAVIME and held (int8-block:
     the host codec's decode byte for byte; none and the copy baselines:
     the field's float32 bits), the pack kernel's launches counted exactly,
     each run's blocked stage_array ms and raw MB/s end to end printed.
     (a) the paper's Fig 6, 2 steps each: rdma_staged with codec none at
     block sizes 1, 4 and 16 MiB, and the scp_mem, scp_disk and ssh_direct
     baselines with codec int8-block set, which must land raw bytes with no
     pack launch and no codec stats; (b) 4 striped channels, int8-block, 2
     steps: 2 launches, wire bytes n + 4 blocks a step, every channel
     carrying stripes; (c) a 2-backend StagingPool behind its gateway,
     int8-block, 4 steps: 4 launches, each step on the backend the hash
     ring names (both backends used), a RouterSession's gather of the last
     step whole, and a second tenant past its quota refused
     (QuotaExceededError) before any backend takes in a byte; (d) (b) under ``FAULT_SPEC`` on the port's
     wire: the read-back still equal, replays plus re-sent stripes at least
     1, launches 2 + replays; (e) ``repro_torch.launch.train.main`` on the
     card at the gemma2-27b smoke config with ``TRAIN_FLAGS`` (2 channels,
     64 KiB coalescing, a fault plan, 50 steps, grads_int8 egress): the loss
     falls, SAVIME holds 50 diagnostics, the pack kernel launches 50 times
     and the flash kernel layers x microbatches x (2 under remat, else 1)
     x 50 times, and the egress rode coalesced frames;
 10. the other architectures (``ARCH_CELLS``), each served as phase 4
     serves its cells (through the kernel, through the plain attention with
     the kernel in lockstep on every attention layer's served q, k, v, then
     warm) at published widths: recurrentgemma-9b at full depth (RG-LRU and
     local attention, MQA at head dim 256), llama4-maverick with 2 layers
     (128 experts top-1 and a shared expert, bf16 params) and paligemma-3b
     at full depth with 256 prefix embeddings before each prompt (the
     prefix-LM mask, head dim 256). The flash kernel must launch once an
     attention layer in each prefill (12, 2, 18) and never in decode; the
     MoE dispatch plan's drops must equal a host recount from the same
     router probabilities; the RG-LRU mixer's and the moe layer's times are
     read, and how far one-step nudges of the attention output move
     recurrentgemma's logits. Then the kernel at these cells' attention
     shapes: against its plain version, the mask probe, and its time beside
     its bound and scaled_dot_product_attention's;
 11. data-parallel training (``data_parallel_on_the_card``), each rank a
     process of its own on the card (spawned, gloo groups: NCCL refuses two
     ranks on one GPU), each rank's step time from CUDA events and its peak
     memory printed with the card's name and power limit: (a) DP equals one
     device (``DP_CHECK``: the reference's distributed check, gemma2-27b
     smoke in f32 at 4 layers so that ZeRO-1 gives each of its two stacked
     periods to one rank at data 2; at data 4 the reference's rule splits
     nothing), meshes 1x2x1 and 2x2x1 against the one-device step
     under the reference's gates, the ranks' params the same bits, the f32
     DP all-reduce timed; (b) the slice at full width (``TRAIN_DP``:
     gemma3-4b at published widths, one period of 6 layers, ``remat="full"``,
     bf16 compute on f32 params, two pods with the int8 error-feedback
     cross-pod reduce, 1 x 4096 tokens a rank, 4 steps, grads_int8 egress
     staged by rank 0 through the port's sink, staging and SAVIME): the
     reduce's quantize (the pack kernel), wire (the ring hop and all-gather
     with their host copies) and dequantize times and the wire bytes a step;
     (c) ``repro_torch.launch.train.main`` with
     ``DP_LAUNCHER_FLAGS`` (gemma2-27b smoke, mesh 2x2x1, compress_pods,
     grads_int8 egress, 20 steps).
 12. serving on a (data, model) mesh (``serve_on_a_mesh``), each rank a
     process on the card through the launcher's ``serve_rank``, with tensor
     and expert parallelism over ``model``: (a) the reference's
     ``check_seq_sharded_decode`` (``MESH_CHECK``: gemma3-4b smoke in f32,
     B 1, S 64, max_len 72, mesh 4x2 with ``seq_shard_kv``); (b)
     ``SERVE_TP``: gemma3-4b at published widths with one period of 6
     layers on 2x2 with ``seq_shard_kv``, B 1, a 4096-token prompt and 16
     new tokens (T = 4112 = 2 x 2056 slots a data rank), in f32 against one
     device and in bf16, with the prefill and decode times, the share of
     each spent in the mesh's collectives, the flash launches and the peak
     memory a rank; (c) the other layer kinds (``TP_KINDS``: mamba with the
     scan on d_inner / 2 channels, RG-LRU, MoE over ``model``, MQA with the
     prefix, both softcaps) at their smoke configs in f32 on 1x2, in one
     spawn; (d) the serve launcher's command line at ``--mesh 2x2`` on its
     default device (``SERVE_CLI_FLAGS``). Then the flash kernel at a 12b rank's attention shapes and the
     scan at a falcon-mamba-7b rank's (di 4096), each against its plain
     version and timed beside its bound and the library call.
 13. training on a (pod, data, model) mesh (``tp_train_on_the_card``), each
     rank a process on the card (gloo), with tensor and expert parallelism
     over ``model`` under autograd (Megatron's pair, the vocab-parallel
     cross-entropy, the grad norm and ZeRO-1 over TP shards): (a) the
     reference's ``check_sharded_equals_single`` (``TP_CHECK``: gemma2-27b
     smoke in f32, B 4, S 64, data seed 1) at 1x2 and 2x2, two steps from a
     seeded state (the first at LR 0) against the one-device step; (b)
     ``TRAIN_TP``: gemma3-4b at published widths, one period of 6 layers,
     ``remat="full"``, bf16 compute on f32 params, mesh 1x2x2 (data 2, model
     2), 1 x 4096 tokens a DP rank, 4 steps, grads_int8 egress, against the
     one-device step on the same global batch, which runs in a process of
     its own first; each rank's step time (CUDA events), the ``model``
     group's collectives (forward; backward with the remat replays; after
     the backward) and the DP all-reduce in ms and as shares of the step,
     tokens/s and peak memory a rank; (c) the other layer kinds
     (``TP_TRAIN_KINDS``: mamba with the scan kernel under ``SelectiveScan``
     on d_inner / 2 channels, RG-LRU with the shared MQA KV head, MoE over
     ``model``, paligemma's prefix and MQA, gemma3's qk-norm) at smoke size
     in f32 on 1x2, llama4 also at 2x2 with ``fsdp_experts``, and on one
     device falcon-mamba smoke's gradients through the scan kernel against
     the plain scan's; (d) the reference's ``check_reshard_restore``
     (``RESHARD``: falcon-mamba smoke saved at (data, model) (1, 4),
     restored at (4, 1) and (2, 2) and on one device), then one step at
     (2, 2) from the restored state against one device's; (e) the train
     launcher with ``TP_LAUNCHER_FLAGS`` (gemma2-27b smoke, mesh 2x1x2,
     compress_pods, grads_int8 egress, in transit, 20 steps). Estimated
     before its first run on the card, from phase 11's and 12's readings:
     (a), (c), (d) ~60 s (eight spawns of 2-4 ranks at ~8 s to reach the
     card, smoke steps of tens of ms); (b) ~90 s (the one-device process
     ~30 s with its 5 GB of params written out, four ranks' start and init
     ~20 s, 4 steps of ~5 s, mostly gloo); (e) ~30 s: about three minutes.
 14. the dry run on the card (``dryrun_on_the_card``): (a) the dry-run
     command line (``repro_torch.launch.dryrun``, meta device, abstract
     production mesh) for ``DRYRUN_CELLS``, in parallel subprocesses, each
     cell's per-rank flops, model flops, useful ratio, bytes, collectives
     by class and peak printed; (b) ``DRYRUN_CARD``: gemma3-4b at published
     widths with 6 layers, bf16 compute on f32 params, ``remat="full"``, one
     device, a training step of 1 x 4096 tokens and a prefill of 4 x 4096,
     and falcon-mamba-7b at published widths with 4 layers, a prefill of
     4 x 4096, each counted once on meta and once on the card under the
     same ``launch.op_analysis`` counter (the kernels launched, their
     formulas counted at the launch), in a process of its own so that the
     card's peak is the step's; then a warm run of each without the
     counter: its ms, TFLOP/s of model flops and the share of the card's
     bf16 peak (989 TFLOP/s); (c) the same gemma3-4b cell's training step
     at ``--mesh 1x2`` (two ranks on the card, gloo) under remat "full",
     "dots" and "comm" and "full" with ``lowp_collectives``: each rank's
     real collective record against the dry run's at 1x2, each variant's
     loss, grad norm, peak memory and warm step ms.

The pack kernel is checked in phase 3 too, byte for byte against its plain
version (reference cases, the codec's ragged sizes, exact ties, the full
mesh) and against the numpy host codec at the full mesh and for float16.

Phase 8's gates, set before its first run on the card:
- launches: the flash kernel exactly 2 layers x 2 microbatches x 2 (forward
  and remat recompute; the backward recomputes through the plain version
  and launches none) = 8 a step; the pack kernel exactly 1 a step;
- step 1 against the plain attention path: |loss - loss_plain| <=
  1e-3 |loss_plain|; grad_norm within 1e-2 relative; every leaf's gradient
  within 1e-2 relative (Frobenius) of the plain path's, a missing gradient
  reading 1.0;
- loss and grad_norm finite at every step;
- SAVIME's read-back: each step's diag equals the loss and grad_norm the
  step returned, and its grad_blocks and scales equal what the kernel
  wrote, bit for bit;
- recovery: loss falls, one restart, SAVIME holds 200 step diagnostics,
  the flash kernel launched 3 layers x 200 steps and the pack kernel 200.

Phase 11's gates, set before its first run on the card:
- (a) at both steps and meshes, loss within 1e-5 relative and grad_norm
  1e-4 of the one-device step's; after the first step (LR 0: the
  reference's own check) every param, and both moments (which hold the
  reduced gradients), within 1e-4 of their leaf's max; every rank's params
  bit for bit rank 0's after each step; the flash kernel 4 layers x 2
  steps a rank. The second step (LR 5e-3) moves the params: each leaf's
  update is held within 1e-2 (Frobenius, relative) of the one-device
  update, where an update left out or broadcast from the wrong rank reads
  1. Its params element by element are read, not gated: the first run on
  the card gated them at 1e-4 of the leaf's max and read 6.0e-4 at 1x2x1
  (Adam's step m/sqrt(v) takes the sign of a near-zero gradient element,
  and that sign follows rounding);
- (b) step 1's reduced flat equal element for element to the same reduce
  re-run from the same per-rank input with the pack's plain version
  quantizing (no pack launch there); for every block, |reduced - the f32
  mean over the pods of g = flat + err| <= sum over pods of scale_p /
  (2 n_pods) + scale_requant / 2 + one f32 ulp of the block's max |mean|;
  the params the same bits on both ranks after every step (two 64-bit
  checksums of their bits) and at the end (sha256); the pack kernel exactly
  2 launches a rank a step plus 1 on rank 0 (the egress); the flash kernel
  6 layers x 2 (remat) a rank a step; the bytes each rank sent and
  received on the pod wire, counted from its buffers, equal to 2 (n-1)/n R
  (QBLOCK + 4) a step, R the params' blocks padded to a multiple of the
  pods (fp32 would move 4 QBLOCK/(QBLOCK + 4) = 3.996 times as much: the
  wire format's arithmetic, not a reading); finite losses; SAVIME holds 4 diagnostics and
  4 sets of blocks and scales;
- (c) the loss falls, SAVIME holds 20 diagnostics, and each rank launched
  the flash kernel 3 layers x 20 steps and the pack kernel 2 x 20 (rank 0:
  3 x 20).

Phase 12's gates, set before its first run on the card: (a), (b) in f32
and (c): the prefill's and every decode step's logits within 1e-4 of the
one-device path's max |logit| (the reference's own gate for its SP decode
check) and the greedy tokens equal; (b) in bf16: the prefill logits within
LOGITS_REL * mean |logit| of the one-device bf16 path; the flash kernel
once an attention layer a prefill on every rank (6 in (b)) and never in
decode; (c) the scan once a mamba layer a rank, each launch on d_inner / 2
channels; (d) rank 0's tokens (4, 32) and the flash kernel once a layer a
rank.

Phase 13's gates, set before its first run on the card:
- (a), (c) and (d), each mesh against the one-device step: loss within
  1e-5 relative and grad_norm 1e-4 at each step; after the first step (LR
  0) every param within 1e-4 of its leaf's max and both moments within
  ``TP_MOMENT_REL`` (5e-4); the second step's update of each leaf within
  1e-2 (Frobenius, relative); every rank's params bit for bit rank 0's; the
  launches a rank exact: the flash kernel once an attention layer a step
  on the rank's heads (gemma2 3 a step, recurrentgemma 1, llama4 3,
  paligemma 2, gemma3 7; the backward recomputes through the plain version
  and launches none; no remat at smoke size), the scan once a mamba layer
  a step (falcon-mamba 2) on d_inner / 2 channels, no pack;
- (b) step 1's loss within 1e-3 relative and grad norm within 1e-2 of the
  one-device step's; the params after step 2 within 1e-2 of one device's,
  relative Frobenius over the whole tree; the DP ranks of each model rank
  the same param bits after every step (two 64-bit checksums); launches
  exact a rank a step: the flash kernel 6 layers x 2 (remat), the pack
  kernel once on rank 0 (the egress, its sample gathered over ``model``)
  and never elsewhere; finite losses. If the four ranks do not fit on the
  card, the slice runs at 1x1x2 and says so;
- (c) falcon-mamba's gradients through the kernel within 1e-6 of each
  leaf's max |g| of the plain scan's (the scan is bit for bit the plain
  version, so the bits are expected equal; the run prints whether they
  are), the kernel launched once a mamba layer;
- (d) the whole state restored at (4, 1), (2, 2) and on one device bit for
  bit the saved one;
- (e) the loss falls, SAVIME holds 20 diagnostics, each rank's launches
  exact (the flash kernel 3 layers x 20; the pack kernel 2 x 20, rank 0
  3 x 20: each model rank quantizes the whole flat in the ring), and each
  rank's pod wire bytes 2 (n-1)/n R (QBLOCK + 4) a step, R the whole
  tree's rows (the reference's flat is the whole tree's).

Phase 14's gates, set before its first run on the card:
- (a) every cell's status ``ok`` and its ``model_flops`` equal to
  ``flops_per_step`` of its config and shape;
- (b) on meta and on the card: ``flops`` (the kernels' formulas included)
  and ``argument_bytes`` equal; ``vpu_flops``, ``hbm_bytes`` and the op
  count equal, or every op whose count differs is printed (PERF.md names
  and explains each), and no matmul-family op differs; the dry run's
  ``peak_bytes`` within ``DRYRUN_PEAK_REL`` (10%) of
  ``torch.cuda.max_memory_allocated`` over the step, the arguments
  included; launches exact: the flash kernel 6 a gemma3 prefill and 12 a
  training step (forward and remat recompute; the backward recomputes
  through the plain version), the scan 4 a falcon-mamba prefill; finite
  outputs;
- (c) each rank's record equal to the dry run's at 1x2 on that rank,
  class by class, in bytes, counts and dtypes; "comm" issues exactly
  2 x 6 = 12 all-reduces fewer than "full" (the attention and MLP output
  sums of each recomputed layer, which the post norms make the recompute
  reach), 12 x 1 x 4096 x 2560 x 4 bytes fewer; under ``lowp`` the bf16
  all-reduce bytes are half the f32 bytes they replace; "dots" and
  "comm" give "full"'s loss and grad norm within ``DRYRUN_REMAT_REL``
  (1e-6 relative; whether the bits are equal is printed), ``lowp`` within
  1e-3 (loss) and 1e-2 (grad norm) of the f32 wire's; the flash kernel 12
  a rank a step.

The last lines are a JSON summary of the kernels, the card line, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import re
import runpy
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
# and that of the deep attention cells of phase 10 one attention output in
# this many
ATTN_NUDGE_EVERY = 8192

GEMMA_SHAPE = dict(Hq=32, Hkv=16, D=128, scale=(4608 / 32) ** -0.5, cap=50.0)
# the attention of the phase-10 cells at head dim 256: recurrentgemma-9b's
# local layers and paligemma-3b's layers (a 256-token prefix); and
# llama4-maverick's (head dim 128, GQA 40/8)
RGLRU_ATTN = dict(Hq=16, Hkv=1, D=256, window=2048, cap=0.0, causal=True)
PREFIX_ATTN = dict(Hq=8, Hkv=1, D=256, window=0, cap=0.0, causal=True, prefix=256)
MOE_ATTN = dict(Hq=40, Hkv=8, D=128, window=0, cap=0.0, causal=True)
# phase 11b's gemma3-4b layers (GQA 8/4 at head dim 256, no cap; window
# 1024 on the local layers), B 1 x S 4096 a rank
GEMMA3_ATTN = dict(Hq=8, Hkv=4, D=256, cap=0.0, causal=True)
SERVE = dict(arch="gemma2-27b", batch=4, prompt_len=4600, new_tokens=32,
             n_layers=4, seed=0, kernel="flash_attention",
             reduced="n_layers 46 -> 4 (two local/global periods, stacked "
                     "scan layout): 46 layers of f32 params do not fit 80 GB")
SERVE_MAMBA = dict(arch="falcon-mamba-7b", batch=4, prompt_len=4600,
                   new_tokens=32, n_layers=64, seed=0, kernel="ssm_scan",
                   reduced="none: full depth, 64 layers (stacked scan layout)")
CELLS = (SERVE, SERVE_MAMBA)
# phase 10: one cell of each layer kind the first cells do not serve, at
# published widths, bf16 compute, random weights from seed 0. Their flash
# launches a prefill are the attention layers of each config: 12 (the local
# layers of 12 R,R,A periods and 2 R), 2 (dense, moe) and 18; the decode
# kernel's launches each decode step are the same counts.
SERVE_RGLRU = dict(arch="recurrentgemma-9b", batch=4, prompt_len=4600,
                   new_tokens=32, n_layers=38, seed=0, kernel="flash_attention",
                   logits_gate=False,
                   logits_gate_reason="38 random-weight layers: one bf16 step "
                   "in 1 of ATTN_NUDGE_EVERY attention outputs moves the "
                   "logits past LOGITS_REL, as the nudge probe reads; the "
                   "lockstep, each attention layer's kernel on its served "
                   "input within kernel_error_limit, is this cell's gate",
                   reduced="none: full depth, 38 layers (12 R,R,A periods in "
                           "the stacked scan layout, then 2 R); 8,578,088,960 "
                           "params in f32 (34.3 GB) and their bf16 compute copy")
SERVE_MOE = dict(arch="llama4-maverick-400b-a17b", batch=4, prompt_len=4600,
                 new_tokens=32, n_layers=2, seed=0, kernel="flash_attention",
                 param_dtype="bfloat16",
                 reduced="n_layers 48 -> 2 (one dense + one moe layer, 128 "
                         "experts: rem layout); param_dtype float32 -> "
                         "bfloat16: the 2 layers' 18,553,262,080 params take 74.2 "
                         "GB in f32 before the compute copy")
# paligemma: 256 prefix embeddings (the SigLIP frontend is a stub in the
# reference too) + 4344 text tokens = 4600 a sequence
SERVE_PREFIX = dict(arch="paligemma-3b", batch=4, prompt_len=4344, n_prefix=256,
                    new_tokens=32, n_layers=18, seed=0, kernel="flash_attention",
                    logits_gate=False,
                    logits_gate_reason="18 random-weight layers: one bf16 "
                    "step in 1 of ATTN_NUDGE_EVERY attention outputs moves "
                    "the logits past LOGITS_REL, as the nudge probe reads; "
                    "the lockstep is this cell's gate",
                    reduced="none: full depth, 18 layers (stacked scan "
                            "layout); the prefix embeddings are seeded normal "
                            "values in bf16, not a vision tower's")
ARCH_CELLS = (SERVE_RGLRU, SERVE_MOE, SERVE_PREFIX)
# phase 5b: the decode-attention kernel at the main path's decode shapes,
# bf16: each served cell's attention decode at its last step (4 rows at
# position 4630, caches of 4632 slots or a local layer's ring), the
# qwen2-72b.batch-decode cell's layer (8 groups of 32 rows at staggered
# positions, as the cell holds them) and one row at the end of a 32k chat
# at qwen2-72b's widths (the dry run's decode_32k length)
# name: (B, T, Hq, Hkv, D, cap, window, the rows' positions)
DECODE_SHAPES = {
    "gemma2-27b global": (4, 4632, 32, 16, 128, 50.0, 0, [4630] * 4),
    "gemma2-27b local": (4, 4096, 32, 16, 128, 50.0, 4096, [4630] * 4),
    "recurrentgemma-9b local": (4, 2048, 16, 1, 256, 0.0, 2048, [4630] * 4),
    "llama4-maverick": (4, 4632, 40, 8, 128, 0.0, 0, [4630] * 4),
    "paligemma-3b": (4, 4632, 8, 1, 256, 0.0, 0, [4630] * 4),
    "qwen2-72b batch decode": (256, 2304, 64, 8, 128, 0.0, 0,
                               [256 + (2 * g + 1) * 128 + i
                                for g in range(8) for i in range(32)]),
    "qwen2-72b 32k chat": (1, 32768, 64, 8, 128, 0.0, 0, [32767]),
}
# the training cell: gemma2-27b at published widths, two layers (one
# local/global period, both masks bind), 4 steps
TRAIN = dict(arch="gemma2-27b", n_layers=2, global_batch=2, seq_len=4600,
             microbatches=2, steps=4, seed=0, peak_lr=3e-4, warmup_steps=1,
             egress_blocks=64,
             reduced="n_layers 46 -> 2 (one local/global period, rem layout): "
                     "f32 params, grads and two AdamW moments take 16 B a "
                     "parameter, 37.0 GB at 2 layers (2,312,151,552 params) and "
                     "55.1 GB at 4, before activations and the plain attention "
                     "backward")
TRAIN_LOSS_REL = 1e-3      # |loss - loss_plain| / |loss_plain|
TRAIN_GNORM_REL = 1e-2     # grad_norm, relative
TRAIN_GRAD_REL = 1e-2      # every leaf's gradient, relative Frobenius
RECOVERY_STEPS = 200       # the example's own settings
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
# phase 9, the paper's transports from the card, at MESH: 2 steps a run in
# 9a, 9b and 9d and 4 in 9c (the paper's trials run 500), 50 training steps
# in 9e. Its time, estimated from phase 6's on the card (~1 s a staged step
# of the mesh, int8-block or none) before the first run of phase 9: 9a
# ~25 s (3 block sizes and 3 copy baselines, whose 16 KiB copies and CRC
# run in Python at a few hundred MB/s), 9b ~4 s, 9c ~8 s, 9d ~5 s, 9e ~10 s,
# and the read-back checks (a host encode and decode of the mesh a step,
# ~1-2 s) ~20 s: about a minute and a quarter in all.
TRANSPORT_STEPS = 2
POOL_STEPS = 4
FIG6_BLOCKS_MIB = (1, 4, 16)
FIG6_BASELINES = ("scp_mem", "scp_disk", "ssh_direct")
STRIPE_CHANNELS = 4
FAULT_SPEC = "seed=42;drop:op=stripe,nth=3"
TRAIN_FLAGS = ["--arch", "gemma2-27b", "--smoke", "--intransit", "--egress",
               "grads_int8", "--channels", "2", "--coalesce-kb", "64",
               "--faults", "seed=7;drop:op=stripe,nth=5", "--steps", "50"]
# phase 11, data-parallel training with the ranks sharing the card. (a) the
# reference's own check (tests/distributed_checks.py: gemma2-27b smoke in f32,
# B 4, S 64, data seed 1) at 4 layers, so that ZeRO-1 splits the two stacked
# periods at data 2; two steps from a seeded state (the first at LR 0), each
# mesh against the one-device step under the reference's gates
DP_CHECK = dict(arch="gemma2-27b", n_layers=4, global_batch=4, seq_len=64,
                data_seed=1, state_seed=7, steps=2, peak_lr=1e-2, warmup_steps=2,
                total_steps=10, meshes=((1, 2, 1), (2, 2, 1)))
DP_LOSS_REL, DP_GNORM_REL, DP_PARAM_REL = 1e-5, 1e-4, 1e-4
DP_UPDATE_REL = 1e-2       # step 1's update of each leaf, relative Frobenius
# (b) gemma3-4b at published widths, one period of its pattern, two pods
# with the int8 error-feedback cross-pod reduce, 1 x 4096 tokens a rank
TRAIN_DP = dict(arch="gemma3-4b", n_layers=6, pods=2, rows_per_rank=1, seq_len=4096,
                steps=4, seed=0, peak_lr=3e-4, warmup_steps=1, egress_blocks=64,
                reduced="n_layers 34 -> 6 (one period: 5 local at window 1024, 1 "
                        "global): 1,237,386,752 params, whose f32 params, two "
                        "moments and error-feedback residual take 19.8 GB a rank "
                        "and the f32 grads and their flat copy 9.9 GB more at the "
                        "reduce, two ranks on one card. One period is not "
                        "stacked, so ZeRO-1 finds no dimension to split (the "
                        "reference's rule) and each rank keeps whole moments")
DP_LAUNCHER_FLAGS = ["--arch", "gemma2-27b", "--smoke", "--mesh", "2x2x1",
                     "--compress-pods", "--intransit", "--egress", "grads_int8",
                     "--steps", "20"]
# phase 12, serving on a (data, model) mesh, the ranks sharing the card. (a)
# the reference's check_seq_sharded_decode: gemma3-4b smoke in f32, B 1, S 64,
# max_len 72 (64 + 8 new), mesh 4x2 with seq_shard_kv
MESH_CHECK = dict(arch="gemma3-4b", batch=1, prompt_len=64, new_tokens=8, mesh="4x2")
# (b) gemma3-4b at published widths, one period, mesh 2x2 with seq_shard_kv:
# T = 4096 + 16 = 4112 = 2 x 2056 slots a data rank; 8/4 heads give a model
# rank 4 query and 2 KV heads
SERVE_TP = dict(arch="gemma3-4b", n_layers=6, batch=1, prompt_len=4096,
                new_tokens=16, mesh="2x2",
                reduced="n_layers 34 -> 6 (one period: 5 local at window 1024, "
                        "1 global): 1,237,386,752 params, ~2.5 GB a rank in f32")
# (c) the other layer kinds at their smoke configs in f32 on mesh 1x2
TP_KINDS = ("falcon-mamba-7b", "recurrentgemma-9b", "llama4-maverick-400b-a17b",
            "paligemma-3b", "gemma2-27b")
TP_KIND_SERVE = dict(batch=2, prompt_len=40, new_tokens=5)
# (d) the serve launcher's command line at 2x2, on its default device
SERVE_CLI_FLAGS = ["--arch", "gemma2-27b", "--smoke", "--mesh", "2x2"]
# the gate of (a), (b) in f32 and (c): every logit within this share of the
# one-device path's max |logit| (the reference's own gate for its SP decode)
TP_LOGITS_REL = 1e-4
# a 12b rank's attention (GQA 4/2 at head dim 256, no cap; window 1024 on the
# local layers), and a falcon-mamba-7b rank's scan at model 2 (di 8192 / 2)
TP_ATTN = dict(Hq=4, Hkv=2, D=256, cap=0.0, causal=True)
TP_SCAN = dict(B=4, S=4600, di=4096, N=16)
# phase 13, training on a (pod, data, model) mesh, the ranks sharing the card.
# (a) the reference's check_sharded_equals_single: gemma2-27b smoke in f32, B
# 4, S 64, data seed 1, at meshes 1x2 and 2x2 ((pod, data, model) (1, 1, 2)
# and (1, 2, 2)); two steps from a seeded state (the first at LR 0) against
# the one-device step, under the reference's gates
TP_CHECK = dict(arch="gemma2-27b", global_batch=4, seq_len=64, data_seed=1,
                state_seed=7, steps=2, peak_lr=1e-2, warmup_steps=2, total_steps=10,
                meshes=((1, 1, 2), (1, 2, 2)))
TP_LOSS_REL, TP_GNORM_REL, TP_PARAM_REL = 1e-5, 1e-4, 1e-4
# the moments after step 0 hold the reduced gradients: each leaf's max
# |error| / max |moment| (a rehearsal of (d) on the CPU read 1.05e-4 at
# falcon-mamba's restored state at 2x2, in f32: the scan amplifies rounding;
# a gradient that TP gets wrong reads order 1)
TP_MOMENT_REL = 5e-4
TP_UPDATE_REL = 1e-2       # step 1's update of each leaf, relative Frobenius
# (b) gemma3-4b at published widths, one period, mesh (pod, data, model)
# (1, 2, 2), bf16 compute on f32 params, 1 x 4096 tokens a DP rank
TRAIN_TP = dict(arch="gemma3-4b", n_layers=6, mesh=(1, 2, 2), rows_per_dp=1,
                seq_len=4096, steps=4, seed=0, peak_lr=3e-4, warmup_steps=1,
                egress_blocks=64,
                reduced="n_layers 34 -> 6 (one period: 5 local at window 1024, 1 "
                        "global): 1,237,386,752 params, ~619M a rank at model 2; "
                        "one period is not stacked, so ZeRO-1 splits nothing (the "
                        "reference's rule) and each rank keeps whole moments for its "
                        "TP shard")
TRAIN_TP_LOSS_REL = 1e-3    # step 1's loss against one device, relative
TRAIN_TP_GNORM_REL = 1e-2   # step 1's grad norm, relative
# the params after step 2, relative Frobenius over the whole tree (a leaf
# alone is ill-conditioned where it starts at zero: gemma's norm scales)
TRAIN_TP_PARAM_REL = 1e-2
# (c) the other layer kinds at their smoke configs in f32 on 1x2 under (a)'s
# gates (llama4 also at 2x2 with fsdp_experts), and falcon-mamba smoke's
# gradients through the scan kernel against the plain scan's on one device
TP_TRAIN_KINDS = ("falcon-mamba-7b", "recurrentgemma-9b",
                  "llama4-maverick-400b-a17b", "paligemma-3b", "gemma3-4b")
SCAN_GRAD_REL = 1e-6        # each leaf's max |g - g_plain| / max |g_plain|
# (d) the reference's check_reshard_restore: falcon-mamba smoke saved at
# (data, model) (1, 4), restored at (4, 1) and (2, 2)
RESHARD = dict(arch="falcon-mamba-7b", state_seed=9, save=(1, 1, 4),
               restore=((1, 4, 1), (1, 2, 2)))
# (e) the train launcher at 2x1x2 with compress_pods, on its default device
TP_LAUNCHER_FLAGS = ["--arch", "gemma2-27b", "--smoke", "--mesh", "2x1x2",
                     "--compress-pods", "--intransit", "--egress", "grads_int8",
                     "--steps", "20"]


# -- phase 14: the dry run on the card ----------------------------------------
# (a) cells of the dry-run command line: (arch, shape, mesh, --opts)
DRYRUN_CELLS = (("gemma3-4b", "train_4k", "single", ""),
                ("llama4-maverick-400b-a17b", "prefill_32k", "single", ""),
                ("qwen2-72b", "decode_32k", "single", ""),
                ("recurrentgemma-9b", "long_500k", "single", ""),
                ("falcon-mamba-7b", "train_4k", "multi", "comm_remat,lowp"))
# (b), (c) gemma3-4b at published widths, 6 layers (phases 11-13's cell),
# bf16 compute on f32 params, remat "full"; falcon-mamba-7b with 4 layers
DRYRUN_CARD = dict(arch="gemma3-4b", n_layers=6, train=(1, 4096),
                   prefill=(4, 4096), mamba="falcon-mamba-7b", mamba_layers=4,
                   mesh=(1, 2), variants=(("full", False), ("dots", False),
                                          ("comm", False), ("full", True)))
DRYRUN_PEAK_REL = 0.10     # |dry-run peak - max_memory_allocated| / the latter
DRYRUN_REMAT_REL = 1e-6    # dots / comm against full: loss, grad norm
DRYRUN_LOWP_LOSS_REL = 1e-3
DRYRUN_LOWP_GNORM_REL = 1e-2


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
    """The cell's model: the registry's config (its smoke config where the
    cell says ``smoke``, as a rehearsal on the CPU does) at the cell's depth
    (and param dtype, where the cell sets one)."""
    from repro_torch.configs import get_config
    cfg = get_config(cell["arch"])
    return dataclasses.replace(cfg.smoke() if cell.get("smoke") else cfg,
                               n_layers=cell["n_layers"],
                               **{k: cell[k] for k in ("param_dtype",) if k in cell})


def prefill_launches(cfg) -> dict:
    """Each kernel's launches in one prefill of the model: the flash kernel
    once an attention layer (a moe layer's attention too), the scan once a
    mamba layer, no decode attention, no pack."""
    kinds = cfg.layer_kinds
    return {"decode_attention": 0,
            "flash_attention": sum(k in ("dense", "local", "global", "moe")
                                   for k in kinds),
            "ssm_scan": sum(k == "mamba" for k in kinds), "staging_pack": 0}


def serve_launches(cfg, new_tokens: int) -> dict:
    """Each kernel's launches in one ``serve`` of ``new_tokens`` tokens: the
    prefill's, and the decode-attention kernel once an attention layer in
    each of the new_tokens - 1 decode steps."""
    want = prefill_launches(cfg)
    want["decode_attention"] = (new_tokens - 1) * want["flash_attention"]
    return want


def decode_error_limit(v) -> float:
    """The decode kernel against its plain version on the same inputs, per
    element: bf16 2**-7 max|v| (one rounding of p and one of o at another
    place than the plain version's), f32 1e-5 max|v| (the order of the
    sums)."""
    import torch
    rel = 2.0 ** -7 if v.dtype == torch.bfloat16 else 1e-5
    return rel * float(v.float().abs().max())


def decode_attention_on_the_card(dev, time_ms) -> dict:
    """Phase 5b: the decode-attention kernel at ``DECODE_SHAPES`` in bf16,
    each row's cache written as the program writes it (position p at slot
    p % T, nothing past the row's position), against its plain version on
    the same inputs within ``decode_error_limit`` (fails on a miss), at the
    launcher's split of the slot axis and at one split; then each timed
    (``time_ms``) beside its plain version, its bound (the bytes of K and V
    up to each row's position, the slots' positions, q and o, once, over
    PEAK_BYTES) and scaled_dot_product_attention with the boolean mask
    (which has no softcap). Returns a row a shape."""
    import torch

    from repro_torch.kernels.decode_attention import kernel, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, (B, T, Hq, Hkv, D, cap, window, pos) in DECODE_SHAPES.items():
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        q = randn(B, 1, Hq, D)
        k, v = (randn(B, T, Hkv * D).view(B, T, Hkv, D) for _ in range(2))
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        t = torch.arange(T, device=dev, dtype=torch.int32)[None]
        cp = torch.where(t <= p[:, None], p[:, None] - (p[:, None] - t) % T, -1)
        cp = cp.to(torch.int32)
        kw = dict(pos=p, cache_positions=cp, scale=D ** -0.5, cap=cap, window=window)
        want = ref.decode_attention(q, k, v, **kw).float()
        limit = decode_error_limit(v)
        splits, chunk = kernel._card_plan(q.device, B, T, Hkv, Hq // Hkv, D, q.dtype)
        one = torch.empty_like(q)

        def one_split():
            kernel._launch(q, k, v, p, cp, one, scale=kw["scale"], cap=cap,
                           window=window, seq_index=0, partial=False, splits=1,
                           chunk=-(-T // kernel.ROUND) * kernel.ROUND)
        one_split()
        err = float((kernel.decode_attention(q, k, v, **kw).float() - want).abs().max())
        err_one = float((one.float() - want).abs().max())
        log(f"decode_attention {name} (B {B}, T {T}, GQA {Hq}/{Hkv}, D {D}, cap "
            f"{cap}, window {window}): max|err| {err:.3g} at {splits} split(s) of "
            f"{chunk} slots, {err_one:.3g} at one split (limit {limit:.3g})")
        if not (err <= limit and err_one <= limit):
            fail(f"decode_attention at {name} disagrees with its plain version")
        visible = (cp >= 0) & (cp <= p[:, None])
        if window:
            visible &= (p[:, None] - cp) < window
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        n = int(ref.slot_bound(p, T).sum())
        row = dict(B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, cap=cap, window=window,
                   max_abs_err=err, max_abs_err_one_split=err_one, limit=limit,
                   splits=splits, chunk=chunk,
                   ms=time_ms(lambda: kernel.decode_attention(q, k, v, **kw), reps=20),
                   ms_one_split=time_ms(one_split, reps=20),
                   plain_ms=time_ms(lambda: ref.decode_attention(q, k, v, **kw)),
                   bound_ms=(n * (2 * Hkv * D * 2 + 4) + 2 * B * Hq * D * 2)
                   / PEAK_BYTES * 1e3,
                   library_ms=time_ms(lambda: sdpa(
                       qt, kt, vt, attn_mask=visible[:, None, None],
                       scale=kw["scale"], enable_gqa=True), reps=20))
        log(f"time decode_attention {name}: kernel {row['ms']:.4f} ms ({splits} "
            f"split(s)), one split {row['ms_one_split']:.4f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms (bytes), "
            f"scaled_dot_product_attention (mask, no softcap) "
            f"{row['library_ms']:.4f} ms")
        rows[name] = row
        del q, k, v, cp, want, one, visible, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def attention_bound_ms(B, S, Hq, Hkv, D, causal, window, dtype,
                       prefix=0) -> tuple[float, str]:
    """Least time for one call: bytes (q, k, v read once, o written once) over
    HBM rate against 4*B*Hq*D*sum|visible k| operations over the dtype's peak
    (the kernel's own count, ``flash_attention/cost.py``)."""
    from repro_torch.kernels.flash_attention.cost import flash_cost
    cost = flash_cost(B, S, S, Hq, Hkv, D, 4 if dtype == "float32" else 2,
                      causal, window, prefix)
    t_bytes, t_ops = cost["bytes"] / PEAK_BYTES, cost["flops"] / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def scan_bound_ms(inputs, outputs) -> tuple[float, str, dict]:
    """Least time for one scan call: the bytes of every input read once and
    every output written once over the HBM rate, against the operations:
    B*S*di*N exponentials over the SFU rate, and the fp32 arithmetic around
    them (dt*A, decay*h, dx*B_t, h*C_t: 6 flops per state update, plus
    dt*x per channel) over the fp32 peak (the kernel's own count,
    ``ssm_scan/cost.py``). The larger of the three."""
    from repro_torch.kernels.ssm_scan.cost import scan_cost
    cost = scan_cost(inputs, outputs)
    nbytes, exps, flops = cost["bytes"], cost["exps"], cost["flops"]
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
    one division per block) over the fp32 peak (the kernel's own count,
    ``staging_pack/cost.py``). The larger of the two."""
    from repro_torch.kernels.staging_pack.cost import pack_cost
    cost = pack_cost(x, q, s)
    nbytes, ops_count = cost["bytes"], cost["flops"]
    times = {"bytes": nbytes / PEAK_BYTES, "operations": ops_count / PEAK_FLOPS["float32"]}
    worst = max(times, key=times.get)
    detail = {"bytes": nbytes, "operations": ops_count,
              **{f"{k}_ms": v * 1e3 for k, v in times.items()}}
    return times[worst] * 1e3, worst, detail


def res_usage(lib_path: Path, cuobjdump: Path) -> dict:
    """``cuobjdump -res-usage``: each function's registers, stack and local
    (spilled) bytes, by mangled name."""
    out = subprocess.run([str(cuobjdump), "-res-usage", str(lib_path)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    usage, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", line)
        if m and name:
            usage[name] = dict(zip(("registers", "stack", "shared", "local"),
                                   map(int, m.groups())))
    return usage


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


def _paths(tree, path=()):
    """(path, leaf) of a nested dict/list tree in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [pl for i, t in enumerate(tree) for pl in _paths(t, path + (i,))]
    return [(path, tree)]


@contextlib.contextmanager
def swapped(module, name: str, value):
    """Replace ``module.name`` by ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _held_steps(savimes, tar: str, n_steps: int) -> dict:
    """step -> (index of the SAVIME server holding it, its "v" values)."""
    held = {}
    for i, sv in enumerate(savimes):
        t = sv.engine.tars.get(tar)
        for st in (t.subtars if t is not None else ()):
            held[st.origin[0]] = (i, st.data["v"].reshape(-1))
    if sorted(held) != list(range(n_steps)):
        fail(f"{tar}: SAVIME holds steps {sorted(held)}, want 0..{n_steps - 1}")
    return held


def transports_from_the_card(dev, mesh: dict, mem_capacity: int,
                             disk_dir: Path) -> dict:
    """Phase 9: the paper's transports driven from a producer on ``dev`` at
    ``mesh``, each step made there by SeismicField and staged through the
    port's sink; every run reads each step back from SAVIME and holds it
    (int8-block: equal byte for byte to the host codec's decode of the
    field; none and the copy baselines: the field's float32 bits) and
    counts the pack kernel's launches exactly. Returns the readings."""
    import torch

    from repro_torch.analysis import tar
    from repro_torch.codec.int8block import Int8BlockCodec
    from repro_torch.configs import get_config
    from repro_torch.core import (InTransitConfig, InTransitSink,
                                  SavimeServer, StagingServer)
    from repro_torch.data.seismic import SeismicConfig, SeismicField
    from repro_torch.faults import FaultPlan, injected
    from repro_torch.gateway import (GatewayClient, QuotaExceededError,
                                     RouterSession, StagingPool, Tenant)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train as train_launch
    from repro_torch.train import TrainConfig
    from repro_torch.transport import TransferSession, TransportConfig

    n = mesh["nx"] * mesh["ny"] * mesh["nz"]
    raw_step = 4 * n
    wire_step = n + 4 * -(-n // CODEC_BLOCK)
    sim = SeismicField(SeismicConfig(**mesh), device=dev)
    host_codec = Int8BlockCodec()
    fields = {}

    def field(step: int):
        if step not in fields:
            fields[step] = sim.step(step).float()
        return fields[step]

    def want_bits(step: int, packed: bool) -> np.ndarray:
        x = field(step).cpu().numpy()
        if packed:
            x = host_codec.decode(*host_codec.encode(x)).view(np.float32)
        return x.reshape(-1).view(np.uint32)

    def check_steps(what: str, savimes, tar_name: str, n_steps: int,
                    packed: bool) -> dict:
        held = _held_steps(savimes, tar_name, n_steps)
        for step, (_, v) in held.items():
            if not np.array_equal(v.view(np.uint32), want_bits(step, packed)):
                fail(f"{what}: step {step} read back differs from "
                     f"{'the host codec decode' if packed else 'the field'}")
        return held

    def stage(what: str, addr: str, cfg, n_steps: int) -> dict:
        """Stage n_steps steps of the mesh through a sink at addr, flushing
        each; per step the ms stage_array blocks the producer and the raw
        MB/s end to end (from the call to stage_array until SAVIME holds
        the step)."""
        sink = InTransitSink(addr, cfg)
        rows = []
        try:
            for step in range(n_steps):
                field(step)
            _sync(dev)
            reset_launches()
            t_run = time.perf_counter()
            for step in range(n_steps):
                t1 = time.perf_counter()
                sink.stage_array("velocity", field(step), step=step)
                t2 = time.perf_counter()
                sink.flush(timeout=600)
                t3 = time.perf_counter()
                rows.append({"stage_ms": (t2 - t1) * 1e3,
                             "flush_ms": (t3 - t2) * 1e3,
                             "raw_mb_per_s": raw_step / 1e6 / (t3 - t1)})
                log(f"{what} step {step}: blocked in stage_array "
                    f"{rows[-1]['stage_ms']:.1f} ms, flush "
                    f"{rows[-1]['flush_ms']:.1f} ms; "
                    f"{rows[-1]['raw_mb_per_s']:.1f} raw MB/s end to end")
            run_s = time.perf_counter() - t_run
            launches = dict(LAUNCHES)
        finally:
            sink.close()
        st = sink.session.stats
        codec = {k: v for k, v in st.codec.items() if k != "encode_s"}
        return {"steps": rows, "run_s": run_s,
                "raw_mb_per_s": n_steps * raw_step / 1e6 / run_s,
                "stage_ms_median": float(np.median([r["stage_ms"] for r in rows])),
                "launches": launches, "codec": codec,
                "channels": st.channels, "replays": st.replays}

    def single(what: str, n_steps: int, spec: str = "", **cfg) -> dict:
        """One run against a SAVIME (and staging, on the staged path)."""
        staged = cfg.get("transport", "rdma_staged") == "rdma_staged"
        savime = SavimeServer().start()
        staging = StagingServer(savime.addr, mem_capacity=mem_capacity,
                                disk_dir=str(disk_dir),
                                send_threads=2).start() if staged else None
        try:
            with injected(FaultPlan.parse(spec),
                          scope=[staging.addr if staged else savime.addr]) as inj:
                r = stage(what, staging.addr if staged else savime.addr,
                          InTransitConfig(io_threads=2, tar_prefix="t9",
                                          max_inflight_bytes=256 << 20, **cfg),
                          n_steps)
            packed = staged and cfg.get("codec") == "int8-block"
            check_steps(what, [savime], "t9_velocity", n_steps, packed)
        finally:
            if staging is not None:
                staging.stop()
            savime.stop()
        r["fired"] = dict(inj.fired)
        return r

    def packs(n: int) -> dict:
        return {"decode_attention": 0, "flash_attention": 0, "ssm_scan": 0,
                "staging_pack": n}

    out = {}
    # -- 9a. the paper's Fig 6 -------------------------------------------------
    free_shm = shm_free_bytes()
    if free_shm < 4 * raw_step:
        fail(f"scp_mem stores a step under /dev/shm: {free_shm} B free, want "
             f"at least {4 * raw_step} (two steps and the staging tier)")
    for mib in FIG6_BLOCKS_MIB:
        what = f"9a rdma_staged block {mib} MiB [none]"
        r = single(what, TRANSPORT_STEPS, block_size=mib << 20)
        if r["launches"] != packs(0) or r["codec"] != {}:
            fail(f"{what}: launches {r['launches']}, codec {r['codec']}")
        out[what] = r
    for engine in FIG6_BASELINES:
        what = f"9a {engine} [int8-block set]"
        r = single(what, TRANSPORT_STEPS, transport=engine, codec="int8-block")
        if r["launches"] != packs(0) or r["codec"] != {}:
            fail(f"{what}: the codec is not inert on a baseline: launches "
                 f"{r['launches']}, codec {r['codec']}")
        out[what] = r

    # -- 9b. striped channels --------------------------------------------------
    def striped(what: str, spec: str = "") -> dict:
        r = single(what, TRANSPORT_STEPS, spec, codec="int8-block",
                   n_channels=STRIPE_CHANNELS)
        want_launches = packs(TRANSPORT_STEPS + r["replays"])
        c = r["codec"]
        if r["launches"] != want_launches or c.get("fallbacks") != 0 or \
                c.get("wire_bytes") != TRANSPORT_STEPS * wire_step + r["replays"] * wire_step:
            fail(f"{what}: launches {r['launches']} (want {want_launches}), "
                 f"codec {c} (want wire {TRANSPORT_STEPS} x {wire_step} a step)")
        live = r["channels"][-STRIPE_CHANNELS:]
        if len(live) != STRIPE_CHANNELS or not any(ch["n_stripes"] for ch in live):
            fail(f"{what}: channel stats {r['channels']}")
        log(f"{what}: channels {json.dumps(r['channels'])}; replays {r['replays']}; "
            f"faults fired {r['fired']}")
        return r

    what = f"9b rdma_staged x{STRIPE_CHANNELS} channels [int8-block]"
    r = striped(what)
    if not all(ch["n_stripes"] > 0 for ch in r["channels"]) or r["replays"]:
        fail(f"{what}: a channel carried no stripe, or a write replayed")
    out[what] = r

    # -- 9c. the staging gateway -------------------------------------------------
    what = "9c StagingPool(2) gateway [int8-block]"
    pool = StagingPool(2, mem_capacity=mem_capacity // 2,
                       tenants=[Tenant("sim", token="tok-sim"),
                                # half of one step's int8 wire bytes
                                Tenant("capped", token="tok-capped",
                                       quota_bytes=wire_step // 2)],
                       staging_kwargs={"disk_dir": str(disk_dir),
                                       "send_threads": 2}).start()
    try:
        # placement hashes the dataset's name against the backends' names
        # only: under the prefix "pool" the 4 steps land on both backends
        # (0, 1, 0, 1), so the gather below merges across them
        r = stage(what, pool.addr, InTransitConfig(
            io_threads=2, tar_prefix="pool", max_inflight_bytes=256 << 20,
            codec="int8-block", gateway=True, tenant="tok-sim"), POOL_STEPS)
        held = check_steps(what, pool.savimes, "pool_velocity", POOL_STEPS, True)
        gc_ = GatewayClient(pool.addr)
        try:
            ring = gc_.ring
        finally:
            gc_.close()
        placed = {step: int(ring.place(f"pool_velocity__{step}").name
                            .removeprefix("backend")) for step in held}
        on = {step: i for step, (i, _) in held.items()}
        datasets = [st.stats["datasets"] for st in pool.stagings]
        last = POOL_STEPS - 1
        with RouterSession(gateway_addr=pool.addr) as rs:
            gathered = rs.execute(tar("pool_velocity").attr("v").range(
                (last, 0, 0, 0), (last, mesh["nx"] - 1, mesh["ny"] - 1,
                                  mesh["nz"] - 1)).select()).array
        whole = np.array_equal(gathered.reshape(-1).view(np.uint32),
                               want_bits(last, True))
        # the second tenant, past its quota: refused before any byte lands
        bytes_before = [st.stats["bytes_in"] for st in pool.stagings]
        reset_launches()
        with TransferSession("rdma_staged", TransportConfig(
                gateway_addr=pool.addr, tenant="tok-capped",
                codec="int8-block")) as capped:
            fut = capped.write("pool_capped", field(0))
            try:
                fut.wait(600)
                refused = None
            except QuotaExceededError as e:
                refused = str(e)
        capped_launches = LAUNCHES["staging_pack"]
        bytes_after = [st.stats["bytes_in"] for st in pool.stagings]
        usage = pool.gateway.tenants.snapshot()
    finally:
        pool.stop()
    log(f"{what}: launches {r['launches']}; backends' datasets {datasets}; "
        f"steps on backends {on}, the ring places them on {placed}; the "
        f"RouterSession's gather of step {last} equal to the host decode: "
        f"{whole}; the capped tenant: {refused!r}, backends' bytes in "
        f"{bytes_before} -> {bytes_after}, its write's pack launches "
        f"{capped_launches} (the encode precedes admission); tenants {usage}")
    if r["launches"] != packs(POOL_STEPS) or sum(datasets) != POOL_STEPS or \
            on != placed or len(set(on.values())) != 2 or not whole:
        fail(f"{what}: launches, datasets, placement or the gather is wrong")
    if refused is None or bytes_after != bytes_before or capped_launches != 1 or \
            usage["capped"]["rejects"] < 1 or usage["capped"]["bytes"] != 0:
        fail(f"{what}: the capped tenant was not refused before any byte landed")
    r.update(backend_datasets=datasets, placement=on, capped_refused=refused,
             capped_launches=capped_launches)
    out[what] = r

    # -- 9d. faults: 9b under a dropped stripe ---------------------------------
    what = f"9d rdma_staged x{STRIPE_CHANNELS} channels [int8-block] under {FAULT_SPEC!r}"
    r = striped(what, FAULT_SPEC)
    resent = sum(ch["adopted"] for ch in r["channels"])
    if r["fired"] != {"drop": 1} or r["replays"] + resent < 1:
        fail(f"{what}: fired {r['fired']}, replays {r['replays']}, re-sent "
             f"stripes {resent}")
    r["resent_stripes"] = resent
    out[what] = r

    # -- 9e. the train launcher with the new flags -----------------------------
    what = "9e launch.train " + " ".join(TRAIN_FLAGS)
    cfg = get_config("gemma2-27b").smoke()
    n_steps = int(TRAIN_FLAGS[TRAIN_FLAGS.index("--steps") + 1])
    want = {"decode_attention": 0,
            "flash_attention": cfg.n_layers * TrainConfig().microbatches
            * (1 if cfg.remat == "none" else 2) * n_steps,
            "ssm_scan": 0, "staging_pack": n_steps}
    reset_launches()
    t0 = time.perf_counter()
    res = train_launch.main([*TRAIN_FLAGS, "--device", str(dev)])
    train_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    losses = [m["loss"] for m in res["metrics"]]
    st, tr = res["staging"], res["transfer"]
    r = {"seconds": train_s, "loss_first": losses[0], "loss_last": losses[-1],
         "diag_rows": int(res["diag"].shape[0]), "launches": launches,
         "want_launches": want, "restarts": res["restarts"],
         "staging": {k: st[k] for k in ("datasets", "batches",
                                        "batched_datasets", "stripes")},
         "replays": tr["replays"],
         "resent_stripes": sum(ch["adopted"] for ch in tr["channels"])}
    log(f"{what} on {dev}: {json.dumps(r)}")
    if not (losses[-1] < losses[0] and r["diag_rows"] == n_steps
            and launches == want and st["batches"] >= 1
            and st["batched_datasets"] >= 3 * n_steps):
        fail(f"{what}: want a falling loss, {n_steps} diagnostics, launches "
             f"{want} and the egress in coalesced frames")
    out[what] = r
    fields.clear()
    return out


# -- phase 11: data-parallel training, the ranks sharing the card ------------------
# Each rank is a process of its own (``repro_torch.launch.spawn.run_ranks``,
# spawn start method, gloo groups: NCCL refuses two ranks on one GPU), on
# cuda:0. The rank functions are this module's, so a rank imports it as
# ``__mp_main__``; ``sys.path`` (with ``src/``) comes from the parent.


def _rank_device():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def _event():
    import torch
    return torch.cuda.Event(enable_timing=True)


def _dp_check_setup(dev, mesh, c: dict):
    """DP_CHECK's model, setup, seeded state and this rank's rows of its
    global batch (the whole batch without a mesh)."""
    from repro_torch.data import (DataConfig, SyntheticLM, batch_to_device,
                                  device_put_batch)
    from repro_torch.models import Model
    from repro_torch.train import TrainConfig, TrainSetup
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(c["arch"]).smoke(), n_layers=c["n_layers"],
                              compute_dtype="float32", param_dtype="float32")
    setup = TrainSetup(Model(cfg), TrainConfig(
        peak_lr=c["peak_lr"], warmup_steps=c["warmup_steps"],
        total_steps=c["total_steps"], egress="none"), mesh)
    state = setup.init_state(c["state_seed"], dev)
    batch = next(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=c["seq_len"],
                                        global_batch=c["global_batch"],
                                        seed=c["data_seed"])).batches())
    batch = (batch_to_device(batch, dev) if mesh is None
             else device_put_batch(batch, mesh, setup.rules, dev,
                                  setup.cfg.microbatches))
    return setup, state, batch


def dp_check_steps(shape) -> dict:
    """Phase 11a on one rank (``shape`` (pod, data, model); None: one
    device, in the calling process): DP_CHECK's steps from the seeded
    state. Returns each step's metrics, CUDA-event time, params and whole
    moments (reference layout, numpy), the launches, the f32 DP
    all-reduce's time and the peak memory."""
    import torch
    from repro_torch.convert import to_reference_layout
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train import train_step as train_step_mod
    c = DP_CHECK
    dev = _rank_device()
    mesh = None if shape is None else Mesh(shape, ("pod", "data", "model"))
    setup, state, batch = _dp_check_setup(dev, mesh, c)
    allreduce_ms = []
    inner_mean = train_step_mod._dp_mean

    def timed_mean(group, t):
        if group.size == 1 or t.numel() < 64:     # the metrics' few scalars
            return inner_mean(group, t)
        _sync(dev)
        t0 = time.perf_counter()
        out = inner_mean(group, t)
        _sync(dev)
        allreduce_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    step = setup.step_fn()
    _sync(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    with swapped(train_step_mod, "_dp_mean", timed_mean):
        for _ in range(c["steps"]):
            start, end = _event(), _event()
            start.record()
            state, m, _ = step(state, batch)
            end.record()
            end.synchronize()
            whole = setup.whole_state(state)
            rows.append({"step_ms": start.elapsed_time(end),
                         **{k: float(v) for k, v in m.items()},
                         "params": to_reference_layout(state["params"]),
                         "mu": to_reference_layout(whole["opt"]["mu"]),
                         "nu": to_reference_layout(whole["opt"]["nu"])})
    return {"steps": rows, "launches": dict(LAUNCHES), "dp_allreduce_ms": allreduce_ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _param_checksums(params) -> tuple[int, int]:
    """Two 64-bit sums of the params' bits on the card: plain, and weighted
    by each word's position mod 65521 (a changed or moved word changes
    them)."""
    import torch
    from repro_torch.models.layers import tree_leaves
    s1 = s2 = 0
    chunk = 1 << 24
    for p in tree_leaves(params):
        words = p.reshape(-1).view(torch.int32)
        for a in range(0, words.numel(), chunk):
            w = words[a:a + chunk].to(torch.int64)
            pos = torch.arange(a, a + w.numel(), device=w.device) % 65521
            s1 += int(w.sum())
            s2 += int((w * pos).sum())
    return s1, s2


def _plain_quant(x):
    """The pack's plain version at the cross-pod block (tile (32, 128)), a
    few thousand rows at a time (each block quantized on its own)."""
    import torch
    from repro_torch.kernels.staging_pack import ref as pack_ref
    from repro_torch.optim import grad_compress as gc
    qs, ss = [], []
    for a in range(0, x.shape[0], gc.CHUNK_ROWS):
        q, s = pack_ref.pack_blocks_ref(x[a:a + gc.CHUNK_ROWS].reshape(-1, 128),
                                        tile=(gc.QBLOCK // 128, 128),
                                        out_dtype=torch.int8)
        qs.append(q)
        ss.append(s)
    return torch.cat(qs), torch.cat(ss)


def dp_full_width(pods: int, disk_dir: str) -> dict:
    """Phase 11b on one rank (one pod): TRAIN_DP at mesh (pods, 1, 1) with
    compress_pods; rank 0 stages each step's egress through the port's
    sink, staging and SAVIME. Times each step (CUDA events) and the
    cross-pod reduce's parts, counts the launches a step, checksums the
    params a step; keeps step 1's reduce input and output on the host, and
    after the run re-runs that reduce with the pack's plain version and
    checks the quantization bound block by block. Returns the readings."""
    import hashlib

    import torch
    from repro_torch.data import DataConfig, SyntheticLM, device_put_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import stage_egress
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import grad_compress as gc
    from repro_torch.train import TrainConfig, TrainSetup
    from repro_torch.train import train_step as train_step_mod
    c = TRAIN_DP
    dev = _rank_device()
    mesh = Mesh((pods, 1, 1), ("pod", "data", "model"))
    pod = mesh.groups["pod"]
    cfg = dataclasses.replace(cell_config(c), remat="full")
    setup = TrainSetup(Model(cfg), TrainConfig(
        peak_lr=c["peak_lr"], warmup_steps=c["warmup_steps"], total_steps=c["steps"],
        compress_pods=True, egress="grads_int8", egress_blocks=c["egress_blocks"]),
        mesh)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=c["seq_len"],
                                  global_batch=pods * c["rows_per_rank"], seed=c["seed"])
                       ).batches()
    batches = [device_put_batch(next(data), mesh, setup.rules, dev,
                                setup.cfg.microbatches)
               for _ in range(c["steps"])]
    torch.cuda.reset_peak_memory_stats()
    state = setup.init_state(c["seed"], dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))

    parts = {"quantize": [], "dequantize": [], "wire": []}

    def events(name, fn):
        def timed(*a, **kw):
            start, end = _event(), _event()
            start.record()
            out = fn(*a, **kw)
            end.record()
            parts[name].append((start, end))
            return out
        return timed

    def wall(fn):
        def timed(*a, **kw):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(dev)
            parts["wire"].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def part_ms(name) -> float:
        _sync(dev)
        return float(sum(x if isinstance(x, float) else x[0].elapsed_time(x[1])
                         for x in parts[name]))

    kept = {}
    inner_reduce = train_step_mod._pod_reduce

    def keeping_reduce(flat, err, group):
        if "flat" in kept or state_step[0] != 1:
            return inner_reduce(flat, err, group)
        kept["flat"] = flat.to("cpu", copy=True)
        kept["err"] = err.to("cpu", copy=True)
        out = inner_reduce(flat, err, group)
        kept["reduced"] = out[0].to("cpu", copy=True)
        return out

    sink = savime = staging = None
    if mesh.rank == 0:
        from repro_torch.core import (InTransitConfig, InTransitSink,
                                      SavimeServer, StagingServer)
        savime = SavimeServer().start()
        staging = StagingServer(savime.addr, disk_dir=disk_dir).start()
        sink = InTransitSink(staging.addr, InTransitConfig(
            io_threads=2, tar_prefix="dp", codec="none"))
    rows, state_step, back = [], [0], None
    try:
        step = setup.step_fn()
        with swapped(gc, "quant_blocks", events("quantize", gc.quant_blocks)), \
                swapped(gc, "dequant_blocks", events("dequantize", gc.dequant_blocks)), \
                swapped(train_step_mod, "_ring_hop", wall(train_step_mod._ring_hop)), \
                swapped(train_step_mod, "_gather_shards",
                        wall(train_step_mod._gather_shards)), \
                swapped(train_step_mod, "_pod_reduce", keeping_reduce):
            _sync(dev)
            reset_launches()
            for i, batch in enumerate(batches):
                state_step[0] = i
                for v in parts.values():
                    v.clear()
                before, wire0 = dict(LAUNCHES), train_step_mod.POD_WIRE["bytes"]
                start, end = _event(), _event()
                start.record()
                state, metrics, egress = step(state, batch)
                end.record()
                end.synchronize()
                row = {"step": i, "step_ms": start.elapsed_time(end),
                       "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       **{f"{k}_ms": part_ms(k) for k in parts},
                       "wire_bytes": train_step_mod.POD_WIRE["bytes"] - wire0,
                       "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES},
                       "param_checksums": _param_checksums(state["params"])}
                if sink is not None:
                    stage_egress(sink, egress, int(state["step"]))
                rows.append(row)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        h = hashlib.sha256()
        for p in tree_leaves(state["params"]):
            h.update(p.detach().reshape(-1).view(torch.uint8).cpu().numpy())
        params_sha = h.hexdigest()
        if sink is not None:
            from repro_torch.analysis import AnalysisSession, tar
            sink.flush(timeout=600)
            with AnalysisSession(savime.addr) as an:
                back = {name: list(an.execute(tar(f"dp_{name}").attr("v").select())
                                   .array.shape)
                        for name in ("diag", "grad_blocks", "grad_scales")}
    finally:
        if sink is not None:
            sink.close()
            staging.stop()
            savime.stop()
    del state, batches, metrics, egress
    torch.cuda.empty_cache()

    # step 1's reduce again, from the same input, with the pack's plain
    # version quantizing; then the bound, block by block, against the f32
    # mean over the pods of g = flat + err
    flat, err = kept["flat"].to(dev), kept["err"].to(dev)
    g_mean = flat + err
    quant_calls = []

    def plain_recording(x):
        out = _plain_quant(x)
        quant_calls.append(out[1])
        return out

    reset_launches()
    with swapped(gc, "quant_blocks", plain_recording):
        plain, _ = train_step_mod._pod_reduce(flat, err, pod)
    plain_launches = dict(LAUNCHES)
    reduced = kept["reduced"].to(dev)
    equal = bool(torch.equal(plain.view(torch.int32), reduced.view(torch.int32)))
    del flat, err, plain
    s_pods = torch.stack(pod.all_gather(quant_calls[0]))          # (pods, rows)
    s_requant = torch.cat(pod.all_gather(quant_calls[1]))          # (rows,)
    pod.all_reduce_sum(g_mean).div_(torch.full((1, 1), float(pods), device=dev))
    err_max = torch.empty(reduced.shape[0], device=dev)
    amax = torch.empty(reduced.shape[0], device=dev)
    for a in range(0, reduced.shape[0], gc.CHUNK_ROWS):
        b = a + gc.CHUNK_ROWS
        err_max[a:b] = (reduced[a:b] - g_mean[a:b]).abs().amax(1)
        amax[a:b] = g_mean[a:b].abs().amax(1)
    ulp = torch.from_numpy(np.spacing(amax.cpu().numpy())).to(dev)
    bound = s_pods.sum(0) / (2 * pods) + s_requant / 2 + ulp
    ratio = err_max / bound
    return {"rank": mesh.rank, "n_params": n_params, "steps": rows, "peak_mem_gb": peak_gb,
            "params_sha256": params_sha, "savime": back,
            "step1_plain_ring_equal": equal, "plain_ring_launches": plain_launches,
            "bound_ratio_max": float(ratio.max()),
            "bound_blocks_over": int((ratio > 1).sum()),
            "n_blocks": int(reduced.shape[0])}


def _leaf_rel(want: dict, got: dict) -> dict:
    """{leaf: max |want - got| / max |want|} over want's leaves."""
    out = {}
    for path, a in _paths(want):
        b = got
        for k in path:
            b = b[k]
        a64 = np.asarray(a, np.float64)
        out["/".join(map(str, path))] = float(
            np.abs(a64 - b).max() / max(np.abs(a64).max(), 1e-30))
    return out


def _update_rel(w0: dict, w1: dict, g0: dict, g1: dict) -> dict:
    """Each leaf's update from step 0 to step 1, against one device's:
    ||(g1 - g0) - (w1 - w0)|| / ||w1 - w0||, Frobenius."""
    out = {}
    for (path, a0), (_, a1), (_, b0), (_, b1) in zip(
            _paths(w0), _paths(w1), _paths(g0), _paths(g1)):
        dw = np.asarray(a1, np.float64) - a0
        dg = np.asarray(b1, np.float64) - b0
        out["/".join(map(str, path))] = float(
            np.linalg.norm(dg - dw) / max(np.linalg.norm(dw), 1e-30))
    return out


def _same_bits(a: dict, b: dict) -> bool:
    pa, pb = _paths(a), _paths(b)
    return len(pa) == len(pb) and all(
        x[0] == y[0] and x[1].tobytes() == y[1].tobytes() for x, y in zip(pa, pb))


def data_parallel_on_the_card(card: str, disk_dir: Path) -> dict:
    """Phase 11: (a) DP equals one device, (b) the slice at full width, (c)
    the launcher at the mesh. Fails on any gate; returns the readings."""
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.launch.train import main as train_main
    from repro_torch.optim import grad_compress as gc
    dp_check, train_dp = DP_CHECK, TRAIN_DP

    leaf_rel, update_rel, same_bits = _leaf_rel, _update_rel, _same_bits

    def readings(steps: list) -> list:
        return [{k: v for k, v in st.items() if k not in ("params", "mu", "nu")}
                for st in steps]

    out = {"card": card}
    # (a) DP equals one device
    t0 = time.perf_counter()
    one = dp_check_steps(None)
    out["dp_check"] = {"1x1": {"steps": readings(one["steps"]), "launches": one["launches"],
                               "peak_mem_gb": one["peak_mem_gb"]}}
    for shape in dp_check["meshes"]:
        name = "x".join(map(str, shape))
        got = run_ranks(dp_check_steps, int(np.prod(shape)), shape)
        r0 = got[0]
        gates, readings = {}, {}
        for i, (w, g) in enumerate(zip(one["steps"], r0["steps"])):
            gates[f"loss_rel_{i}"] = abs(g["loss"] - w["loss"]) / abs(w["loss"])
            gates[f"grad_norm_rel_{i}"] = abs(g["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
        # step 0 (LR 0) is the reference's check: params, and the moments,
        # which hold (1 - b) g and (1 - b) g^2 of the reduced grads
        w, g = one["steps"][0], r0["steps"][0]
        gates["param_rel_0"] = max(leaf_rel(w["params"], g["params"]).values())
        gates["moment_rel_0"] = max(max(leaf_rel(w[m], g[m]).values()) for m in ("mu", "nu"))
        # step 1 (LR 5e-3) moves the params: its update, leaf by leaf, in
        # the Frobenius norm against one device's (the ZeRO-1 share update
        # and the params' gather or broadcast; an update left out or taken
        # from the wrong rank reads 1). Element by element, Adam's step
        # m/sqrt(v) takes the sign of a near-zero gradient element, which
        # follows rounding: that reading has no limit
        upd = update_rel(one["steps"][0]["params"], one["steps"][1]["params"],
                         r0["steps"][0]["params"], r0["steps"][1]["params"])
        worst = max(upd, key=upd.get)
        gates["update_rel_1"] = upd[worst]
        readings["update_rel_1_leaf"] = worst
        last = leaf_rel(one["steps"][-1]["params"], r0["steps"][-1]["params"])
        worst = max(last, key=last.get)
        readings["param_rel_last"] = [worst, last[worst]]
        ranks_equal = all(same_bits(s["params"], t["params"])
                          for r in got[1:] for s, t in zip(r["steps"], r0["steps"]))
        want_launches = {"decode_attention": 0,
                         "flash_attention": dp_check["n_layers"] * dp_check["steps"],
                         "ssm_scan": 0, "staging_pack": 0}
        row = {"gates": gates, "readings": readings, "ranks_params_bit_equal": ranks_equal,
               "step_ms": [[s["step_ms"] for s in r["steps"]] for r in got],
               "dp_allreduce_ms": [r["dp_allreduce_ms"] for r in got],
               "peak_mem_gb": [r["peak_mem_gb"] for r in got],
               "launches": [r["launches"] for r in got]}
        out["dp_check"][name] = row
        log(f"dp 11a, mesh {name} against 1x1 ({dp_check['arch']} smoke "
            f"n_layers={dp_check['n_layers']} f32, B {dp_check['global_batch']} S "
            f"{dp_check['seq_len']}; {card}): {json.dumps(row)} (limits: loss "
            f"{DP_LOSS_REL}, grad_norm {DP_GNORM_REL}, params and moments {DP_PARAM_REL} "
            f"of each leaf's max, step 1's update {DP_UPDATE_REL})")
        if not (all(v < DP_LOSS_REL for k, v in gates.items() if k.startswith("loss"))
                and all(v < DP_GNORM_REL for k, v in gates.items() if k.startswith("grad"))
                and gates["param_rel_0"] < DP_PARAM_REL
                and gates["moment_rel_0"] < DP_PARAM_REL
                and gates["update_rel_1"] < DP_UPDATE_REL and ranks_equal
                and all(r["launches"] == want_launches for r in got)):
            fail(f"dp 11a at mesh {name}: {row}, want launches {want_launches} a rank")
    out["dp_check_s"] = time.perf_counter() - t0
    log(f"dp 11a done in {out['dp_check_s']:.1f} s")

    # (b) the slice at full width
    t0 = time.perf_counter()
    pods = train_dp["pods"]
    got = run_ranks(dp_full_width, pods, pods, str(disk_dir))
    cfg = cell_config(train_dp)
    want_step = [{"decode_attention": 0, "flash_attention": cfg.n_layers * 2, "ssm_scan": 0,
                  "staging_pack": 2 + (r == 0)} for r in range(pods)]
    n_steps = train_dp["steps"]
    # the wire a rank a step: n - 1 hops of the reduce-scatter and n - 1
    # shards of the all-gather, each R / n blocks of QBLOCK int8 values and
    # a 4 B scale, R the residual's rows (the params' values in blocks,
    # padded to a multiple of the pods)
    rows = -(-got[0]["n_params"] // gc.QBLOCK)
    rows = -(-rows // pods) * pods
    want_wire = 2 * (pods - 1) * (rows // pods) * (gc.QBLOCK + 4)
    bad = []
    for r, g in enumerate(got):
        if any(s["launches"] != want_step[r] for s in g["steps"]):
            bad.append(f"rank {r} launches {[s['launches'] for s in g['steps']]}")
        if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in g["steps"]):
            bad.append(f"rank {r}: a loss or grad_norm is not finite")
        if not g["step1_plain_ring_equal"] or g["plain_ring_launches"]["staging_pack"]:
            bad.append(f"rank {r}: step 1's reduce differs from the plain ring's "
                       f"(launches {g['plain_ring_launches']})")
        if g["bound_blocks_over"]:
            bad.append(f"rank {r}: {g['bound_blocks_over']} blocks past the bound "
                       f"(max ratio {g['bound_ratio_max']})")
        if g["n_blocks"] != rows or any(s["wire_bytes"] != want_wire for s in g["steps"]):
            bad.append(f"rank {r}: {g['n_blocks']} blocks (want {rows}), wire bytes "
                       f"{[s['wire_bytes'] for s in g['steps']]} a step (want {want_wire})")
    for i in range(n_steps):
        if len({tuple(g["steps"][i]["param_checksums"]) for g in got}) != 1:
            bad.append(f"params differ across ranks after step {i}")
    if len({g["params_sha256"] for g in got}) != 1:
        bad.append("the final params differ across ranks")
    if got[0]["savime"] != {"diag": [n_steps, 2],
                            "grad_blocks": [n_steps, train_dp["egress_blocks"], 1024],
                            "grad_scales": [n_steps, train_dp["egress_blocks"]]}:
        bad.append(f"SAVIME holds {got[0]['savime']}")
    warm = {r: {k: float(np.median([s[k] for s in g["steps"][2:]]))
                for k in ("step_ms", "quantize_ms", "wire_ms", "dequantize_ms")}
            for r, g in enumerate(got)}
    full = {"config": f"{cfg.name} n_layers={cfg.n_layers} remat=full, mesh {pods}x1x1 "
                      f"compress_pods, {train_dp['rows_per_rank']} x {train_dp['seq_len']} "
                      f"tokens a rank",
            "reduced": train_dp["reduced"], "n_params": got[0]["n_params"],
            "wire_bytes_a_step": want_wire,
            "fp32_wire_bytes_a_step": 2 * (pods - 1) * (rows // pods) * gc.QBLOCK * 4,
            "warm_median_steps_2_3": warm,
            "ranks": [{k: v for k, v in g.items() if k not in ("params_sha256",)}
                      for g in got],
            "seconds": time.perf_counter() - t0}
    out["full_width"] = full
    for g in got:
        for s in g["steps"]:
            log(f"dp 11b rank {g['rank']} step {s['step']} ({card}): {json.dumps(s)}")
    log(f"dp 11b ({card}): {full['config']}; {full['n_params']} params; warm (median of "
        f"steps 2-3) {json.dumps(warm)}; peak memory a rank "
        f"{[round(g['peak_mem_gb'], 3) for g in got]} GB; step 1 against the plain "
        f"ring: {[g['step1_plain_ring_equal'] for g in got]}; bound ratio max "
        f"{[g['bound_ratio_max'] for g in got]} over {got[0]['n_blocks']} blocks "
        f"(limit 1); SAVIME {got[0]['savime']}; {full['seconds']:.1f} s")
    if bad:
        fail(f"dp 11b: {bad}")

    # (c) the launcher at the mesh
    t0 = time.perf_counter()
    res = train_main(DP_LAUNCHER_FLAGS)
    steps = int(DP_LAUNCHER_FLAGS[DP_LAUNCHER_FLAGS.index("--steps") + 1])
    from repro_torch.configs import get_config
    smoke = get_config("gemma2-27b").smoke()
    want = [{"decode_attention": 0, "flash_attention": smoke.n_layers * steps, "ssm_scan": 0,
             "staging_pack": steps * (2 + (r == 0))} for r in range(4)]
    losses = [m["loss"] for m in res["metrics"]]
    launcher = {"seconds": time.perf_counter() - t0, "loss_first": losses[0],
                "loss_last": losses[-1], "diag_rows": int(res["diag"].shape[0]),
                "launches_by_rank": res["launches_by_rank"], "pod_wire": res["pod_wire"],
                "restarts": res["restarts"]}
    out["launcher"] = launcher
    log(f"dp 11c, repro_torch.launch.train.main {' '.join(DP_LAUNCHER_FLAGS)} ({card}): "
        f"{json.dumps(launcher)}; want launches {want}")
    if not (losses[-1] < losses[0] and launcher["diag_rows"] == steps
            and res["launches_by_rank"] == want):
        fail(f"dp 11c: {launcher}, want launches {want}")
    return out


# -- phase 12: serving on a (data, model) mesh, the ranks sharing the card ----------


def _serve_kw(**over) -> dict:
    """Every keyword of the launcher's per-rank serve, on the card."""
    return {"temperature": 0.0, "seed": 0, "device": "cuda", "prompts": None,
            "prefix_embed": None, "seq_shard_kv": False, "keep_logits": True,
            **over}


def mesh_serve_rank(mesh_spec: str, jobs: list) -> list:
    """Phase 12 on one rank of ``mesh_spec``: each job (config, keywords)
    through the launcher's ``serve_rank``, with the wall time of the mesh's
    collectives (gloo over pinned host buffers, the card synchronised on
    both sides) summed a phase, and the width of every scan launch. Returns
    for each job rank 0's results (host tensors) or this rank's launches
    and peak memory, with its collective ms and scan widths."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.ssm_scan import kernel as scan_kernel
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.serve import serve_rank
    # the jobs' device: the card, or the CPU in a rehearsal of the phase
    dev = _rank_device() if jobs[0][1]["device"] == "cuda" else torch.device("cpu")
    gloo, current, widths = {}, ["setup"], []

    def timed(fn):
        def wrapper(self, *a, **kw):
            if self.size == 1:
                return fn(self, *a, **kw)
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            _sync(dev)
            gloo[current[0]] = gloo.get(current[0], 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    @contextlib.contextmanager
    def phase(name):
        current[0] = name
        try:
            yield
        finally:
            current[0] = "other"

    inner_scan = scan_kernel.ssm_scan

    def scan_seen(xi, *a, **kw):
        widths.append(int(xi.shape[-1]))
        return inner_scan(xi, *a, **kw)

    out = []
    with swapped(mesh_mod.AxisGroup, "all_reduce_sum",
                 timed(mesh_mod.AxisGroup.all_reduce_sum)), \
            swapped(mesh_mod.AxisGroup, "all_gather", timed(mesh_mod.AxisGroup.all_gather)), \
            swapped(scan_kernel, "ssm_scan", scan_seen):
        for cfg, kw in jobs:
            gloo.clear()
            widths.clear()
            current[0] = "setup"
            res = serve_rank(mesh_spec, cfg, kw, log=log, phase=phase)
            res.pop("params", None)
            res.update(rank=dist.get_rank(), gloo_ms=dict(gloo), scan_widths=list(widths))
            out.append(res)
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _logits_rel(want: dict, got: dict) -> dict:
    """Prefill's and each decode step's max |err| over the one-device max
    |logit|, and whether the tokens are equal."""
    import torch
    scale = float(want["prefill_logits"].float().abs().max())
    steps = (got["step_logits"].float() - want["step_logits"].float()).abs()
    return {"prefill": float((got["prefill_logits"].float().cpu()
                              - want["prefill_logits"].float().cpu()).abs().max()) / scale,
            "decode_max": float(steps.amax()) / scale if steps.numel() else 0.0,
            "tokens_equal": torch.equal(got["tokens"].cpu(), want["tokens"].cpu())}


def serve_on_a_mesh(card: str, dev) -> dict:
    """Phase 12: (a) the reference's SP decode check at 4x2, (b) gemma3-4b at
    published widths on 2x2 with seq_shard_kv, in f32 against one device
    and in bf16 for the times, (c) the other layer kinds at 1x2, (d) the
    serve launcher's command line at 2x2. Each mesh of (a) to (c) is one
    ``run_ranks`` call of ``mesh_serve_rank``, its one-device runs first in
    this process with their logits kept on the host; (d) spawns its ranks
    itself. Fails on any gate; returns the readings."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.spawn import run_ranks

    def one_device(cfg, **kw):
        res = serve(cfg, device=dev, keep_logits=True, log=lambda m: None, **kw)
        keep = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in res.items() if k != "params"}
        del res
        gc.collect()
        torch.cuda.empty_cache()
        return keep

    out, bad = {"card": card}, []

    # (a) the reference's check at 4x2
    t0 = time.perf_counter()
    c = MESH_CHECK
    cfg = dataclasses.replace(get_config(c["arch"]).smoke(), compute_dtype="float32")
    kw = {k: c[k] for k in ("batch", "prompt_len", "new_tokens")}
    want = one_device(cfg, **kw)
    got = run_ranks(mesh_serve_rank, 8, c["mesh"],
                    [(cfg, _serve_kw(**kw, seq_shard_kv=True))])
    rel = _logits_rel(want, got[0][0])
    a = {"logits_rel": rel, "launches": [g[0]["launches"] for g in got],
         "seconds": time.perf_counter() - t0}
    out["check_4x2"] = a
    log(f"mesh 12a, {cfg.name} f32 B {c['batch']} S {c['prompt_len']} max_len "
        f"{c['prompt_len'] + c['new_tokens']}, mesh {c['mesh']} seq_shard_kv, against "
        f"one device ({card}): {json.dumps(a)} (limit {TP_LOGITS_REL} of max |logit|, "
        f"tokens equal)")
    if not (rel["prefill"] < TP_LOGITS_REL and rel["decode_max"] < TP_LOGITS_REL
            and rel["tokens_equal"]):
        bad.append(f"12a: {rel}")

    # (b) gemma3-4b at published widths on 2x2
    t0 = time.perf_counter()
    c = SERVE_TP
    base = cell_config(c)
    kw = {k: c[k] for k in ("batch", "prompt_len", "new_tokens")}
    cfgs = {d: dataclasses.replace(base, compute_dtype=d) for d in ("float32", "bfloat16")}
    want = {d: one_device(cfgs[d], **kw) for d in cfgs}
    got = run_ranks(mesh_serve_rank, 4, c["mesh"],
                    [(cfgs[d], _serve_kw(**kw, seq_shard_kv=True)) for d in cfgs])
    r0 = {d: got[0][i] for i, d in enumerate(cfgs)}
    rel = _logits_rel(want["float32"], r0["float32"])
    lg_w = want["bfloat16"]["prefill_logits"].float()
    bf16_err = float((r0["bfloat16"]["prefill_logits"].float() - lg_w).abs().max())
    bf16_mean = float(lg_w.abs().mean())
    want_launch = prefill_launches(base)
    lat = np.asarray(r0["bfloat16"]["decode_ms"])
    b = {"config": f"{base.name} n_layers={base.n_layers}, mesh {c['mesh']} "
                   f"seq_shard_kv, B {c['batch']} x {c['prompt_len']} + {c['new_tokens']}",
         "reduced": c["reduced"], "f32_logits_rel": rel,
         "bf16_prefill_max_abs_err": bf16_err, "bf16_mean_abs_logit": bf16_mean,
         "bf16_tokens_equal": torch.equal(r0["bfloat16"]["tokens"].cpu(),
                                          want["bfloat16"]["tokens"].cpu()),
         "prefill_ms": r0["bfloat16"]["prefill_ms"],
         "decode_p50_ms": float(np.percentile(lat, 50)),
         "decode_p99_ms": float(np.percentile(lat, 99)),
         "one_device_prefill_ms": want["bfloat16"]["prefill_ms"],
         "one_device_decode_p50_ms": float(np.percentile(want["bfloat16"]["decode_ms"], 50)),
         "gloo_ms_by_rank": [g[1]["gloo_ms"] for g in got],
         "gloo_share_prefill": [g[1]["gloo_ms"].get("prefill", 0.0) / r0["bfloat16"]["prefill_ms"]
                                for g in got],
         "gloo_share_decode": [g[1]["gloo_ms"].get("decode", 0.0) / float(lat.sum())
                               for g in got],
         "launches_by_rank": [[g[i]["launches"] for g in got] for i in range(2)],
         "flash_launches_by_rank": [[g[i]["launches"]["flash_attention"] for g in got]
                                    for i in range(2)],
         "flash_launches_want": want_launch["flash_attention"],
         "peak_mem_gb_by_rank": [[g[i]["peak_mem_gb"] for g in got] for i in range(2)],
         "one_device_peak_mem_gb": [want[d]["peak_mem_gb"] for d in cfgs],
         "seconds": time.perf_counter() - t0}
    out["full_width"] = b
    log(f"mesh 12b ({card}): {json.dumps(b)} (limits: f32 {TP_LOGITS_REL} of max "
        f"|logit| and tokens equal; bf16 prefill {LOGITS_REL} * mean |logit|)")
    if not (rel["prefill"] < TP_LOGITS_REL and rel["decode_max"] < TP_LOGITS_REL
            and rel["tokens_equal"] and bf16_err <= LOGITS_REL * bf16_mean
            and all(n == want_launch["flash_attention"]
                    for row in b["flash_launches_by_rank"] for n in row)):
        bad.append(f"12b: f32 {rel}, bf16 {bf16_err} against {LOGITS_REL * bf16_mean}, "
                   f"flash launches {b['flash_launches_by_rank']}")
    del want, got, r0
    gc.collect()

    # (c) the other layer kinds at 1x2, one run_ranks call
    t0 = time.perf_counter()
    cfgs = [dataclasses.replace(get_config(a).smoke(), compute_dtype="float32")
            for a in TP_KINDS]
    want = [one_device(k, **TP_KIND_SERVE) for k in cfgs]
    got = run_ranks(mesh_serve_rank, 2, "1x2", [(k, _serve_kw(**TP_KIND_SERVE)) for k in cfgs])
    kinds = {}
    for i, k in enumerate(cfgs):
        rel = _logits_rel(want[i], got[0][i])
        launches = [g[i]["launches"] for g in got]
        widths = [g[i]["scan_widths"] for g in got]
        want_l = serve_launches(k, TP_KIND_SERVE["new_tokens"])
        kinds[k.name] = {"logits_rel": rel, "launches": launches, "scan_widths": widths}
        di_half = k.d_inner // 2
        if not (rel["prefill"] < TP_LOGITS_REL and rel["decode_max"] < TP_LOGITS_REL
                and rel["tokens_equal"]
                and all(l_ == want_l for l_ in launches)
                and all(w == [di_half] * want_l["ssm_scan"] for w in widths)):
            bad.append(f"12c {k.name}: {kinds[k.name]}, want launches {want_l}, scan "
                       f"widths {di_half}")
    out["kinds_1x2"] = {"kinds": kinds, "seconds": time.perf_counter() - t0}
    log(f"mesh 12c, each layer kind's smoke config in f32 at 1x2 against one device "
        f"({card}): {json.dumps(out['kinds_1x2'])} (limit {TP_LOGITS_REL} of max "
        f"|logit|, tokens equal; the scan on d_inner / 2 channels)")

    # (d) the launcher's command line at 2x2 on the card
    from repro_torch.launch.serve import main as serve_main
    t0 = time.perf_counter()
    res = serve_main(SERVE_CLI_FLAGS)
    # the launcher's default of 32 new tokens
    want_l = serve_launches(get_config("gemma2-27b").smoke(), 32)
    d = {"flags": SERVE_CLI_FLAGS, "tokens_shape": list(res["tokens"].shape),
         "launches_by_rank": res["launches_by_rank"],
         "peak_mem_gb_by_rank": res["peak_mem_gb_by_rank"],
         "prefill_ms": res["prefill_ms"],
         "decode_p50_ms": float(np.percentile(res["decode_ms"], 50)),
         "seconds": time.perf_counter() - t0}
    out["cli_2x2"] = d
    log(f"mesh 12d, repro_torch.launch.serve.main {' '.join(SERVE_CLI_FLAGS)} ({card}): "
        f"{json.dumps(d)}; want tokens [4, 32] and launches {want_l} a rank")
    if d["tokens_shape"] != [4, 32] or any(l_ != want_l for l_ in d["launches_by_rank"]):
        bad.append(f"12d: {d}")
    if bad:
        fail(f"serving on a mesh: {bad}")
    return out


# -- phase 13: training on a (pod, data, model) mesh, the ranks sharing the card --
# The rank functions take the device by name ("cuda", or "cpu" to rehearse
# the phase at smoke size on the CPU, where no kernel launches).


def _device(device: str):
    import torch
    return _rank_device() if device == "cuda" else torch.device("cpu")


class _Clock:
    """Milliseconds between two points on the device's clock (CUDA events)
    or, on the CPU, the host's."""

    def __init__(self, dev):
        import torch
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.a, self.b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.a.record()
        else:
            self.t0 = time.perf_counter()

    def ms(self) -> float:
        if not self.cuda:
            return (time.perf_counter() - self.t0) * 1e3
        self.b.record()
        self.b.synchronize()
        return self.a.elapsed_time(self.b)


def _tp_smoke_setup(dev, mesh, arch: str, train_kw: dict):
    """TP_CHECK's setup of ``arch``'s smoke config in f32 on ``mesh`` (None:
    one device) and this rank's rows of its global batch."""
    from repro_torch.configs import get_config
    from repro_torch.data import (DataConfig, SyntheticLM, batch_to_device,
                                  device_put_batch)
    from repro_torch.models import Model
    from repro_torch.train import TrainConfig, TrainSetup
    c = TP_CHECK
    cfg = dataclasses.replace(get_config(arch).smoke(), compute_dtype="float32",
                              param_dtype="float32")
    setup = TrainSetup(Model(cfg), TrainConfig(
        peak_lr=c["peak_lr"], warmup_steps=c["warmup_steps"],
        total_steps=c["total_steps"], egress="none", **train_kw), mesh)
    batch = next(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=c["seq_len"], global_batch=c["global_batch"],
        seed=c["data_seed"], n_prefix=cfg.n_prefix, d_model=cfg.d_model)).batches())
    batch = (batch_to_device(batch, dev) if mesh is None
             else device_put_batch(batch, mesh, setup.rules, dev,
                                  setup.cfg.microbatches))
    return setup, batch


def tp_smoke_steps(dev, mesh, arch: str, train_kw=None, steps=None,
                   ckpt_dir=None) -> dict:
    """``steps`` (default TP_CHECK's) of ``arch``'s smoke step on this rank
    of ``mesh`` (None: one device), from the seeded state or from the
    checkpoint in ``ckpt_dir``. Returns each step's metrics, time and whole
    params and moments (reference layout, numpy), the whole state as
    restored (with ``ckpt_dir``), the launches and the peak memory."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import to_reference_layout
    from repro_torch.kernels import LAUNCHES, reset_launches
    setup, batch = _tp_smoke_setup(dev, mesh, arch, train_kw or {})
    restored = None
    if ckpt_dir is None:
        state = setup.init_state(TP_CHECK["state_seed"], dev)
    else:
        ckpt = CheckpointManager(ckpt_dir, layout=setup if mesh is not None else None)
        state = ckpt.restore(setup.state_specs(), device=dev)
        ckpt.close()
        restored = to_reference_layout(setup.whole_state(state))
    step = setup.step_fn()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    for _ in range(TP_CHECK["steps"] if steps is None else steps):
        clock = _Clock(dev)
        state, m, _ = step(state, batch)
        ms = clock.ms()
        whole = setup.whole_state(state)
        rows.append({"step_ms": ms, **{k: float(v) for k, v in m.items()},
                     "params": to_reference_layout(whole["params"]),
                     "mu": to_reference_layout(whole["opt"]["mu"]),
                     "nu": to_reference_layout(whole["opt"]["nu"])})
    return {"steps": rows, "launches": dict(LAUNCHES), "restored": restored,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if dev.type == "cuda" else None)}


def tp_save(dev, mesh, arch: str, directory: str) -> dict:
    """RESHARD's state (seeded, step 0) saved on ``mesh`` as checkpoint
    step 1, rank 0 writing. Returns the whole state it saved."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import to_reference_layout
    setup, _ = _tp_smoke_setup(dev, mesh, arch, {})
    state = setup.init_state(RESHARD["state_seed"], dev)
    ckpt = CheckpointManager(directory, async_writes=False, layout=setup)
    ckpt.save(state, 1)
    ckpt.wait()
    ckpt.close()
    return to_reference_layout(setup.whole_state(state))


def tp_rank_jobs(shape, device: str, jobs: list) -> list:
    """Phase 13 (a), (c) and (d) on one rank of the (pod, data, model) mesh
    of ``shape``: each job (``kind`` "steps" with ``tp_smoke_steps``'
    keywords, or "save" with ``tp_save``'s) in order. Returns their
    results."""
    from repro_torch.launch.mesh import Mesh
    dev = _device(device)
    mesh = Mesh(shape, ("pod", "data", "model"))
    run = {"steps": tp_smoke_steps, "save": tp_save}
    return [run[job["kind"]](dev, mesh, **{k: v for k, v in job.items() if k != "kind"})
            for job in jobs]


def _tp_gates(one: dict, got: list, want_launches: dict) -> dict:
    """(a)'s gates of a mesh run (``got``, rank by rank) against the one-
    device run: loss and grad_norm at each step, the params and moments
    after the first (LR 0), the second step's update of each leaf, every
    rank's params the same bits, and the launches a rank."""
    gates, readings = {}, {}
    r0 = got[0]
    for i, (w, g) in enumerate(zip(one["steps"], r0["steps"])):
        gates[f"loss_rel_{i}"] = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        gates[f"grad_norm_rel_{i}"] = abs(g["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
    w, g = one["steps"][0], r0["steps"][0]
    gates["param_rel_0"] = max(_leaf_rel(w["params"], g["params"]).values())
    gates["moment_rel_0"] = max(max(_leaf_rel(w[m], g[m]).values()) for m in ("mu", "nu"))
    if len(one["steps"]) > 1:
        upd = _update_rel(one["steps"][0]["params"], one["steps"][1]["params"],
                          r0["steps"][0]["params"], r0["steps"][1]["params"])
        worst = max(upd, key=upd.get)
        gates["update_rel_1"] = upd[worst]
        readings["update_rel_1_leaf"] = worst
    equal = all(_same_bits(s["params"], t["params"])
                for r in got[1:] for s, t in zip(r["steps"], r0["steps"]))
    ok = (all(v < TP_LOSS_REL for k, v in gates.items() if k.startswith("loss"))
          and all(v < TP_GNORM_REL for k, v in gates.items() if k.startswith("grad"))
          and gates["param_rel_0"] < TP_PARAM_REL and gates["moment_rel_0"] < TP_MOMENT_REL
          and gates.get("update_rel_1", 0.0) < TP_UPDATE_REL and equal
          and all(r["launches"] == want_launches for r in got))
    return {"ok": ok, "gates": gates, "readings": readings,
            "ranks_params_bit_equal": equal, "launches": [r["launches"] for r in got],
            "want_launches": want_launches,
            "step_ms": [[s["step_ms"] for s in r["steps"]] for r in got],
            "peak_mem_gb": [r["peak_mem_gb"] for r in got]}


def mamba_grads_through_the_kernel(dev) -> dict:
    """(c): falcon-mamba smoke's gradients at TP_CHECK's seeded state and
    batch on one device, through the scan kernel (under ``SelectiveScan``
    on the card) and through the plain scan. Returns each leaf's max |g -
    g_plain| / max |g_plain|, whether every leaf's bits are equal, and the
    kernel's launches in the kernel run. Raises where the kernel path gives
    a leaf no gradient (a scan without a backward)."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.layers import tree_leaves
    setup, batch = _tp_smoke_setup(dev, None, "falcon-mamba-7b", {})
    params = setup.init_state(TP_CHECK["state_seed"], dev)["params"]
    reset_launches()
    g_kernel = tree_leaves(setup._value_and_grad(params, batch)[2])
    launches = dict(LAUNCHES)
    with swapped(ssm_mod, "selective_scan", ssm_scan_ref):
        g_plain = tree_leaves(setup._value_and_grad(params, batch)[2])
    rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for a, b in zip(g_kernel, g_plain)]
    return {"max_rel": max(rel), "bit_equal": all(torch.equal(a, b) for a, b in
                                                  zip(g_kernel, g_plain)),
            "launches": launches, "n_leaves": len(rel)}


def tp_full_width(shape, device: str, cell: dict, ref_dir: str) -> dict:
    """(b) on one rank of the (pod, data, model) mesh of ``shape``, or with
    ``shape`` None on one device: ``cell`` (TRAIN_TP) at the same global
    batch, ``remat="full"``, ``grads_int8`` egress. One device runs two
    steps and writes its params after the second to ``ref_dir``, one .npy
    a leaf; a rank runs every step, reads those params back for its own
    cut of each leaf after the second step, and returns the squared
    Frobenius norms of its counted part's difference, of the reference, and
    of the reference's move from the initial params (summed over the model
    ranks by the caller). Each step's time (CUDA
    events), loss, grad norm, launches and param checksums, and the
    milliseconds spent in the ``model`` group's collectives (forward,
    backward with the remat replays, and after the backward: the shared
    gradients' sum, the norm, the egress sample) and in the DP all-reduce
    are returned, with the peak memory."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM, batch_to_device, device_put_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import TrainConfig, TrainSetup
    from repro_torch.train import train_step as train_step_mod
    from repro_torch.train.sharding import local_slice, take
    dev = _device(device)
    mesh = None if shape is None else Mesh(shape, ("pod", "data", "model"))
    c = cell
    cfg = dataclasses.replace(cell_config(c), remat="full")
    n_steps = 2 if mesh is None else c["steps"]
    setup = TrainSetup(Model(cfg), TrainConfig(
        peak_lr=c["peak_lr"], warmup_steps=c["warmup_steps"], total_steps=c["steps"],
        egress="grads_int8", egress_blocks=c["egress_blocks"]), mesh)
    dp = int(np.prod(c["mesh"][:2]))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=c["seq_len"],
                                  global_batch=dp * c["rows_per_dp"], seed=c["seed"])
                       ).batches()
    batches = [next(data) for _ in range(n_steps)]
    batches = [batch_to_device(b, dev) if mesh is None
               else device_put_batch(b, mesh, setup.rules, dev,
                                     setup.cfg.microbatches) for b in batches]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = setup.init_state(c["seed"], dev)
    # the initial shard, on the host: the reference's move from it
    p0 = ([] if mesh is None else
          [p.to("cpu", copy=True) for p in tree_leaves(state["params"])])

    spent = {"forward": 0.0, "backward": 0.0, "after": 0.0, "dp": 0.0}
    phase = ["after"]
    if mesh is not None:
        group = mesh.groups["model"]

        def timed(fn):
            def run(*a, **kw):
                _sync(dev)
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                _sync(dev)
                spent[phase[0]] += (time.perf_counter() - t0) * 1e3
                return out
            return run

        for name in ("all_reduce_sum", "all_gather", "gather"):
            setattr(group, name, timed(getattr(group, name)))
    inner_vg, inner_loss = setup._value_and_grad, Model.loss_fn

    def value_and_grad(params, batch, *a):
        phase[0] = "backward"       # outside loss_fn: the backward, replays
        try:
            return inner_vg(params, batch, *a)
        finally:
            phase[0] = "after"

    def loss_fn(self, *a, **kw):
        phase[0] = "forward"
        try:
            return inner_loss(self, *a, **kw)
        finally:
            phase[0] = "backward"

    setup._value_and_grad = value_and_grad
    inner_mean = train_step_mod._dp_mean

    def timed_mean(grp, t):
        if grp.size == 1 or t.numel() < 64:         # the metrics' few scalars
            return inner_mean(grp, t)
        _sync(dev)
        t0 = time.perf_counter()
        out = inner_mean(grp, t)
        _sync(dev)
        spent["dp"] += (time.perf_counter() - t0) * 1e3
        return out

    # step 1's reduced gradients, leaf by leaf: the squared norm of the
    # part of each that this rank counts (the whole leaf on one device)
    grad_sq = []
    inner_update = train_step_mod.adamw_update

    def recording_update(grads, *a, **kw):
        if not grad_sq:
            for j, g in enumerate(tree_leaves(grads)):
                counted = setup.norm.counted[j] if setup.norm is not None else None
                if counted is not None and any(not r for r in counted):
                    grad_sq.append(0.0)
                    continue
                part = g if counted is None else take(g, counted)
                grad_sq.append(float(part.double().square().sum()))
        return inner_update(grads, *a, **kw)

    rows, compare = [], None
    step = setup.step_fn()
    with swapped(Model, "loss_fn", loss_fn), swapped(train_step_mod, "_dp_mean", timed_mean), \
            swapped(train_step_mod, "adamw_update", recording_update):
        reset_launches()
        for i, batch in enumerate(batches):
            for k in spent:
                spent[k] = 0.0
            before = dict(LAUNCHES)
            clock = _Clock(dev)
            state, metrics, egress = step(state, batch)
            ms = clock.ms()
            rows.append({"step": i, "step_ms": ms, "loss": float(metrics["loss"]),
                         "grad_norm": float(metrics["grad_norm"]),
                         **{f"tp_{k}_ms" if k != "dp" else "dp_allreduce_ms": v
                            for k, v in spent.items()},
                         "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES},
                         "egress": {k: list(v.shape) for k, v in egress.items()},
                         "param_checksums": _param_checksums(state["params"])})
            if i != 1:
                continue
            specs = tree_leaves(setup.param_specs)
            leaves = tree_leaves(state["params"])
            if mesh is None:
                Path(ref_dir).mkdir(parents=True, exist_ok=True)
                for j, p in enumerate(leaves):
                    np.save(Path(ref_dir) / f"{j}.npy", p.float().cpu().numpy())
                continue
            compare = []
            for j, (p, spec) in enumerate(zip(leaves, specs)):
                ref = np.load(Path(ref_dir) / f"{j}.npy", mmap_mode="r")
                ref = torch.from_numpy(np.ascontiguousarray(
                    take(ref, local_slice(spec, mesh, setup.rules, cfg)))).to(dev)
                mine, start = p.float(), p0[j].to(dev).float()
                counted = setup.norm.counted[j]
                if counted is not None:
                    if any(not r for r in counted):
                        compare.append((0.0, 0.0, 0.0))
                        continue
                    mine, ref, start = (take(t, counted) for t in (mine, ref, start))
                compare.append((float((mine - ref).double().square().sum()),
                                float(ref.double().square().sum()),
                                float((ref - start).double().square().sum())))
                del ref, start
    return {"rank": 0 if mesh is None else mesh.rank,
            "coords": None if mesh is None else mesh.coords, "steps": rows,
            "compare": compare, "grad_sq": grad_sq,
            "leaf_names": ["/".join(map(str, path)) for path, _ in _paths(setup.param_specs)],
            "n_params": sum(int(np.prod(s.shape)) for s in tree_leaves(setup.param_specs)),
            "n_local": sum(p.numel() for p in tree_leaves(state["params"])),
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if dev.type == "cuda" else None)}


def tp_train_on_the_card(card: str, device: str = "cuda",
                         cell: dict = None, build_dir: Path = ROOT / "build") -> dict:
    """Phase 13: (a) the sharded step equals one device, (b) the slice at
    full width, (c) the other layer kinds and the scan's gradients, (d) the
    reshard twin, (e) the launcher at 2x1x2. Fails on any gate; returns the
    readings. ``device`` "cpu" and a small ``cell`` rehearse it on the CPU
    (no kernel launches there)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import Model
    from repro_torch.optim import grad_compress as gc
    cell = cell or TRAIN_TP
    dev = _device(device)
    on_card = device == "cuda"
    steps = TP_CHECK["steps"]

    def smoke(arch):
        return dataclasses.replace(get_config(arch).smoke(), compute_dtype="float32",
                                   param_dtype="float32")

    def want(arch, n_steps):
        per = prefill_launches(smoke(arch))
        return {k: (v * n_steps if on_card else 0) for k, v in per.items()}

    def ranks(shape, jobs):
        return run_ranks(tp_rank_jobs, int(np.prod(shape)), shape, device, jobs)

    out = {"card": card}
    t0 = time.perf_counter()
    ck = build_dir / "tp13d-ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    # the one-device runs, in this process
    one = {a: tp_smoke_steps(dev, None, a) for a in ("gemma2-27b", *TP_TRAIN_KINDS)}
    fsdp = {"fsdp_experts": True}
    # (d) first: the save at (1, 4) and the restore at (4, 1)
    saved = ranks(RESHARD["save"], [{"kind": "save", "arch": RESHARD["arch"],
                                     "directory": str(ck)}])
    back_41 = ranks(RESHARD["restore"][0], [{"kind": "steps", "arch": RESHARD["arch"],
                                             "steps": 0, "ckpt_dir": str(ck)}])
    one["restored"] = tp_smoke_steps(dev, None, RESHARD["arch"], steps=1, ckpt_dir=str(ck))
    # (a) and (c) at 1x2; (a), llama4 with fsdp_experts and (d)'s step at 2x2
    at_12 = ranks(TP_CHECK["meshes"][0],
                  [{"kind": "steps", "arch": a} for a in ("gemma2-27b", *TP_TRAIN_KINDS)])
    at_22 = ranks(TP_CHECK["meshes"][1], [
        {"kind": "steps", "arch": "gemma2-27b"},
        {"kind": "steps", "arch": "llama4-maverick-400b-a17b", "train_kw": fsdp},
        {"kind": "steps", "arch": RESHARD["arch"], "steps": 1, "ckpt_dir": str(ck)}])
    bad = []
    rows = {}
    for name, got, one_run, arch in (
            ("13a 1x2", [r[0] for r in at_12], one["gemma2-27b"], "gemma2-27b"),
            ("13a 2x2", [r[0] for r in at_22], one["gemma2-27b"], "gemma2-27b"),
            *((f"13c {a} 1x2", [r[1 + i] for r in at_12], one[a], a)
              for i, a in enumerate(TP_TRAIN_KINDS)),
            ("13c llama4 fsdp_experts 2x2", [r[1] for r in at_22],
             one["llama4-maverick-400b-a17b"], "llama4-maverick-400b-a17b"),
            ("13d step at 2x2 from the restored state", [r[2] for r in at_22],
             one["restored"], RESHARD["arch"])):
        row = _tp_gates(one_run, got, want(arch, len(one_run["steps"])))
        rows[name] = row
        log(f"tp {name} against one device ({arch} smoke f32, B "
            f"{TP_CHECK['global_batch']} S {TP_CHECK['seq_len']}; {card}): "
            f"{json.dumps(row)} (limits: loss {TP_LOSS_REL}, grad_norm {TP_GNORM_REL}, "
            f"params and moments after step 0 {TP_PARAM_REL} and {TP_MOMENT_REL} of "
            f"each leaf's max, step 1's update {TP_UPDATE_REL})")
        if not row["ok"]:
            bad.append(name)
    out["meshes"] = rows
    # (c) the scan's gradients through the kernel against the plain scan
    scan = mamba_grads_through_the_kernel(dev)
    out["scan_grads"] = scan
    want_scan = smoke("falcon-mamba-7b").n_layers if on_card else 0
    log(f"tp 13c falcon-mamba smoke step-1 grads through the scan kernel "
        f"(SelectiveScan) against the plain scan ({card}): {json.dumps(scan)} "
        f"(limit {SCAN_GRAD_REL} of each leaf's max |g|; scan launches want {want_scan})")
    if scan["max_rel"] > SCAN_GRAD_REL or scan["launches"]["ssm_scan"] != want_scan:
        bad.append("13c scan grads")
    # (d) the restores, bit for bit
    whole = saved[0][0]
    restores = {"(4, 1)": [r[0]["restored"] for r in back_41],
                "(2, 2)": [r[2]["restored"] for r in at_22],
                "one device": [one["restored"]["restored"]]}
    equal = {k: all(_same_bits(w, whole) for w in v) for k, v in restores.items()}
    equal["saved on every rank"] = all(_same_bits(s[0], whole) for s in saved)
    out["reshard"] = equal
    log(f"tp 13d {RESHARD['arch']} smoke saved at (data, model) (1, 4), restored "
        f"bit for bit: {json.dumps(equal)}")
    if not all(equal.values()):
        bad.append("13d restore")
    out["small_s"] = time.perf_counter() - t0
    if bad:
        fail(f"tp 13a/c/d: {bad}")
    log(f"tp 13a, 13c, 13d done in {out['small_s']:.1f} s")

    # (b) the slice at full width: one device first, in a process of its own
    t0 = time.perf_counter()
    ref_dir = build_dir / "tp13b-one-device"
    shutil.rmtree(ref_dir, ignore_errors=True)
    one_b = run_ranks(tp_full_width, 1, None, device, cell, str(ref_dir))[0]
    mesh_shape = tuple(cell["mesh"])
    try:
        got = run_ranks(tp_full_width, int(np.prod(mesh_shape)), mesh_shape, device,
                        cell, str(ref_dir))
    except RuntimeError as e:
        if "out of memory" not in str(e).lower() or mesh_shape == (1, 1, 2):
            raise
        log(f"tp 13b: mesh {mesh_shape} ran out of memory; the slice at (1, 1, 2)")
        mesh_shape = (1, 1, 2)
        cell = {**cell, "mesh": mesh_shape}
        got = run_ranks(tp_full_width, 2, mesh_shape, device, cell, str(ref_dir))
    shutil.rmtree(ref_dir, ignore_errors=True)
    cfg = cell_config(cell)
    n_steps = cell["steps"]
    want_step = [{"decode_attention": 0,
                  "flash_attention": (cfg.n_layers * 2 if on_card else 0), "ssm_scan": 0,
                  "staging_pack": int(on_card and r == 0)} for r in range(len(got))]
    bad = []
    s1, o1 = got[0]["steps"][0], one_b["steps"][0]
    gates = {"loss_rel_step1": abs(s1["loss"] - o1["loss"]) / abs(o1["loss"]),
             "grad_norm_rel_step1": abs(s1["grad_norm"] - o1["grad_norm"]) / o1["grad_norm"]}
    dp0 = [g for g in got if g["coords"]["data"] == 0 and g["coords"]["pod"] == 0]
    sums = np.sum([g["compare"] for g in dp0], axis=0)         # (leaves, 3)
    gates["param_rel_step2"] = float(np.sqrt(sums[:, 0].sum() / sums[:, 1].sum()))
    rel = np.sqrt(sums[:, 0] / np.maximum(sums[:, 1], 1e-300))
    # step 1's gradient norm leaf by leaf against one device's: the leaves
    # whose norms differ most
    g_tp = np.sqrt(np.sum([g["grad_sq"] for g in dp0], axis=0))
    g_one = np.sqrt(np.asarray(one_b["grad_sq"]))
    g_rel = np.abs(g_tp - g_one) / np.maximum(g_one, 1e-30)
    names = got[0]["leaf_names"]
    readings = {"param_rel_step2_worst_leaf": [names[int(rel.argmax())], float(rel.max())],
                "grad_norm_rel_step1_by_leaf": [
                    [names[j], float(g_one[j]), float(g_tp[j]), float(g_rel[j])]
                    for j in np.argsort(-g_rel)[:4]],
                "grad_norm_step1_largest_leaves": [
                    [names[j], float(g_one[j]), float(g_tp[j])]
                    for j in np.argsort(-g_one)[:3]],
                # the step's move against one device's: ||p - p_one|| /
                # ||p_one - p_0|| over the tree (an update left out reads 1)
                "update_rel_step2": float(np.sqrt(sums[:, 0].sum() / sums[:, 2].sum()))}
    for r, g in enumerate(got):
        if any(s["launches"] != want_step[r] for s in g["steps"]):
            bad.append(f"rank {r} launches {[s['launches'] for s in g['steps']]}")
        if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in g["steps"]):
            bad.append(f"rank {r}: a loss or grad_norm is not finite")
    for i in range(n_steps):
        for m in range(mesh_shape[2]):
            sums_m = {tuple(g["steps"][i]["param_checksums"]) for g in got
                      if g["coords"]["model"] == m}
            if len(sums_m) != 1:
                bad.append(f"model rank {m}'s DP ranks differ after step {i}")
    if got[0]["steps"][0]["egress"] != {"diag": [2], "blocks": [cell["egress_blocks"], 1024],
                                        "scales": [cell["egress_blocks"]]}:
        bad.append(f"egress {got[0]['steps'][0]['egress']}")
    if not (gates["loss_rel_step1"] < TRAIN_TP_LOSS_REL
            and gates["grad_norm_rel_step1"] < TRAIN_TP_GNORM_REL
            and gates["param_rel_step2"] < TRAIN_TP_PARAM_REL):
        bad.append(f"gates {gates}")
    tokens = int(np.prod(mesh_shape[:2])) * cell["rows_per_dp"] * cell["seq_len"]
    warm = {}
    for r, g in enumerate(got):
        w = g["steps"][2:] or g["steps"]
        med = {k: float(np.median([s[k] for s in w])) for k in (
            "step_ms", "tp_forward_ms", "tp_backward_ms", "tp_after_ms", "dp_allreduce_ms")}
        med["tp_share"] = (med["tp_forward_ms"] + med["tp_backward_ms"]
                           + med["tp_after_ms"]) / med["step_ms"]
        med["dp_share"] = med["dp_allreduce_ms"] / med["step_ms"]
        warm[r] = med
    step_s = float(np.median([warm[r]["step_ms"] for r in warm])) / 1e3
    full = {"config": f"{cfg.name} n_layers={cfg.n_layers} remat=full bf16 compute, "
                      f"mesh {mesh_shape} (pod, data, model), {cell['rows_per_dp']} x "
                      f"{cell['seq_len']} tokens a DP rank",
            "reduced": cell["reduced"], "mesh": list(mesh_shape),
            "n_params": got[0]["n_params"], "n_params_a_rank": [g["n_local"] for g in got],
            "gates": gates, "readings": readings,
            "warm_median_steps_2_3": warm, "tokens_per_s": tokens / step_s,
            "one_device": {"step_ms": [s["step_ms"] for s in one_b["steps"]],
                           "peak_mem_gb": one_b["peak_mem_gb"],
                           "tokens_per_s": tokens / (one_b["steps"][-1]["step_ms"] / 1e3)},
            "peak_mem_gb": [g["peak_mem_gb"] for g in got],
            "ranks": [{k: v for k, v in g.items() if k != "compare"} for g in got],
            "seconds": time.perf_counter() - t0}
    out["full_width"] = full
    for g in got:
        for s in g["steps"]:
            log(f"tp 13b rank {g['rank']} {g['coords']} step {s['step']} ({card}): "
                f"{json.dumps(s)}")
    log(f"tp 13b ({card}): {full['config']}; {full['n_params']} params, a rank "
        f"{full['n_params_a_rank']}; gates {json.dumps(gates)} (limits: loss "
        f"{TRAIN_TP_LOSS_REL}, grad_norm {TRAIN_TP_GNORM_REL}, params after step 2 "
        f"{TRAIN_TP_PARAM_REL} Frobenius over the tree); readings "
        f"{json.dumps(readings)}; warm (median of steps 2-3) {json.dumps(warm)}; "
        f"{full['tokens_per_s']:.0f} tokens/s; one device {json.dumps(full['one_device'])}; "
        f"peak memory a rank {[g['peak_mem_gb'] for g in got]} GB; {full['seconds']:.1f} s")
    if bad:
        fail(f"tp 13b: {bad}")

    # (e) the launcher at 2x1x2 with compress_pods
    t0 = time.perf_counter()
    flags = TP_LAUNCHER_FLAGS + (["--device", "cpu"] if not on_card else [])
    res = train_main(flags)
    n = int(TP_LAUNCHER_FLAGS[TP_LAUNCHER_FLAGS.index("--steps") + 1])
    sm = get_config("gemma2-27b").smoke()
    want_l = [{"decode_attention": 0,
               "flash_attention": sm.n_layers * n if on_card else 0, "ssm_scan": 0,
               "staging_pack": n * (2 + (r == 0)) if on_card else 0} for r in range(4)]
    rows_w = gc.error_state(Model(sm).param_specs(), 2)[0]
    want_wire = n * 2 * (2 - 1) * (rows_w // 2) * (gc.QBLOCK + 4)
    losses = [m["loss"] for m in res["metrics"]]
    launcher = {"seconds": time.perf_counter() - t0, "loss_first": losses[0],
                "loss_last": losses[-1], "diag_rows": int(res["diag"].shape[0]),
                "launches_by_rank": res["launches_by_rank"], "pod_wire": res["pod_wire"],
                "want_pod_wire_bytes": want_wire, "restarts": res["restarts"]}
    out["launcher"] = launcher
    log(f"tp 13e, repro_torch.launch.train.main {' '.join(flags)} ({card}): "
        f"{json.dumps(launcher)}; want launches {want_l}")
    if not (losses[-1] < losses[0] and launcher["diag_rows"] == n
            and res["launches_by_rank"] == want_l
            and res["pod_wire"]["bytes"] == want_wire):
        fail(f"tp 13e: {launcher}, want launches {want_l}")
    return out


def _dryrun_cfg(arch: str, n_layers: int, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=n_layers, **kw)


def dryrun_cli(out_dir: Path) -> dict:
    """Phase 14a: ``DRYRUN_CELLS`` through the dry-run command line, one
    subprocess a cell, all at once. Returns each cell's record; fails
    unless each is ``ok`` with ``model_flops`` equal to ``flops_per_step``."""
    from repro_torch.configs import SHAPES, flops_per_step, get_config
    from repro_torch.launch.dryrun import cell_path, parse_opts
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    procs = {}
    for arch, shape, mesh, opts in DRYRUN_CELLS:
        procs[(arch, shape, mesh, opts)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", mesh, "--opts", opts, "--quiet",
             "--out", str(out_dir)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for (arch, shape, mesh, opts), proc in procs.items():
        try:
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        name = f"{arch} {shape} {mesh}" + (f" {opts}" if opts else "")
        if proc.returncode != 0:
            fail(f"14a dry run {name} exited {proc.returncode}: {err[-2000:]}")
        rec = json.loads(Path(cell_path(arch, shape, mesh, out=str(out_dir))).read_text())
        cfg, _ = parse_opts(get_config(arch), opts)
        want = flops_per_step(cfg, SHAPES[shape])
        if rec["status"] != "ok" or rec["model_flops"] != want:
            fail(f"14a {name}: status {rec['status']}, model_flops "
                 f"{rec.get('model_flops')} against flops_per_step {want}")
        useful = rec["model_flops"] / (rec["flops"] * rec["n_chips"])
        log(f"14a {name}: a rank of {rec['n_chips']}: flops {rec['flops']:.4e}, "
            f"model_flops {rec['model_flops']:.4e} (useful {useful:.3f}), "
            f"hbm_bytes {rec['hbm_bytes']:.4e}, collectives "
            f"{json.dumps(rec['collectives']['bytes'])} B "
            f"{json.dumps(rec['collectives']['counts'])}, peak "
            f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB, traced in {rec['trace_s']} s")
        out[name] = {**{k: rec[k] for k in ("flops", "vpu_flops", "hbm_bytes",
                                             "model_flops", "n_chips", "trace_s",
                                             "collectives", "memory", "n_ops")},
                     "useful": useful}
    return out


def _counted_on_the_card(cfg, shape, dev) -> dict:
    """One step of the cell on the card under the op counter, the card's
    peak over the step, the launches, and a warm run's ms."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import op_analysis
    from repro_torch.launch.dryrun import build_step
    fn, args = build_step(cfg, shape, None, device=dev, seed=0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, rep = op_analysis.analyze(fn, *args, device="cuda", by_op=True)
    torch.cuda.synchronize()
    rep["card_peak_bytes"] = torch.cuda.max_memory_allocated()
    rep["card_before_bytes"] = before
    rep["launches"] = dict(LAUNCHES)
    first = out[1]["loss"] if shape.kind == "train" else out[0]
    rep["finite"] = bool(torch.isfinite(first.float()).all())
    del out
    clock = _Clock(dev)
    fn(*args)
    rep["ms"] = clock.ms()
    del args
    return rep


def dryrun_counts_rank(cases: list) -> list:
    """Phase 14b in a process of its own: each case (arch, n_layers, kind,
    B, S) counted on meta and on the card. Returns both counts each."""
    import torch

    from repro_torch.configs import ShapeConfig, flops_per_step
    from repro_torch.launch.dryrun import count_step
    dev = _rank_device()
    res = []
    for arch, n_layers, kind, B, S in cases:
        cfg = _dryrun_cfg(arch, n_layers)
        shape = ShapeConfig(f"14b_{kind}", S, B, kind)
        meta = count_step(cfg, shape, None, by_op=True)
        card = _counted_on_the_card(cfg, shape, dev)
        gc.collect()
        torch.cuda.empty_cache()
        res.append({"meta": meta, "card": card,
                    "model_flops": flops_per_step(cfg, shape)})
    return res


def dryrun_mesh_rank(variants: list) -> list:
    """Phase 14c on one rank of the 1x2 mesh: for each (remat, lowp), the
    dry run's record on this rank's abstract mesh, then two real steps
    (the first recorded, the second timed), the loss, grad norm, peak
    memory and launches."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.dryrun import build_step, count_step
    from repro_torch.launch.mesh import AbstractMesh, Mesh, record_collectives
    from repro_torch.models.layers import lowp_collectives
    c = DRYRUN_CARD
    dev = _rank_device()
    axes = ("data", "model")
    mesh = Mesh(c["mesh"], axes)
    shape = ShapeConfig("14c_train", c["train"][1], c["train"][0], "train")
    out = []
    for remat, lowp in variants:
        cfg = _dryrun_cfg(c["arch"], c["n_layers"], remat=remat)
        dry = count_step(cfg, shape, AbstractMesh(c["mesh"], axes, mesh.rank),
                         lowp=lowp)
        fn, (state, batch) = build_step(cfg, shape, mesh, device=dev, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with lowp_collectives(lowp):
            with record_collectives() as rec:
                state, m, _ = fn(state, batch)
            torch.cuda.synchronize()
            clock = _Clock(dev)
            state, _, _ = fn(state, batch)
            ms = clock.ms()
        out.append({"remat": remat, "lowp": lowp, "record": rec,
                    "dry": {"bytes": dry["collective_bytes"],
                            "counts": dry["collective_counts"],
                            "dtype_bytes": dry["collective_dtype_bytes"]},
                    "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "loss_bits": m["loss"].float().cpu().numpy().tobytes(),
                    "gnorm_bits": m["grad_norm"].float().cpu().numpy().tobytes(),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "ms": ms, "launches": dict(LAUNCHES)})
        del state, batch, fn
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dryrun_on_the_card(card: str, out_dir: Path) -> dict:
    """Phase 14 (a), (b), (c); fails on any gate; returns the readings."""
    from repro_torch.launch.spawn import run_ranks
    c = DRYRUN_CARD
    res = {"card": card}
    t0 = time.perf_counter()
    res["cli"] = dryrun_cli(out_dir)
    log(f"14a done in {time.perf_counter() - t0:.1f} s")

    # (b)
    t1 = time.perf_counter()
    cases = [(c["arch"], c["n_layers"], "train", *c["train"]),
             (c["arch"], c["n_layers"], "prefill", *c["prefill"]),
             (c["mamba"], c["mamba_layers"], "prefill", *c["prefill"])]
    names = ["gemma3-4b train", "gemma3-4b prefill", "falcon-mamba-7b prefill"]
    want_launches = [{"decode_attention": 0, "flash_attention": 2 * c["n_layers"],
                      "ssm_scan": 0, "staging_pack": 0},
                     {"decode_attention": 0, "flash_attention": c["n_layers"],
                      "ssm_scan": 0, "staging_pack": 0},
                     {"decode_attention": 0, "flash_attention": 0,
                      "ssm_scan": c["mamba_layers"], "staging_pack": 0}]
    got = run_ranks(dryrun_counts_rank, 1, cases)[0]
    res["counts"] = {}
    matmuls = {"aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm", "aten.convolution"}
    for name, r, want in zip(names, got, want_launches):
        meta, cardr = r["meta"], r["card"]
        diff = {op: (meta["by_op"].get(op, 0), cardr["by_op"].get(op, 0))
                for op in set(meta["by_op"]) | set(cardr["by_op"])
                if meta["by_op"].get(op, 0) != cardr["by_op"].get(op, 0)}
        peak_rel = abs(meta["peak_bytes"] - cardr["card_peak_bytes"]) / cardr["card_peak_bytes"]
        share = r["model_flops"] / (cardr["ms"] * 1e-3 * PEAK_FLOPS["bfloat16"])
        row = {k: (meta[k], cardr[k]) for k in ("flops", "vpu_flops", "hbm_bytes",
                                                 "n_ops", "argument_bytes", "peak_bytes")}
        row.update(card_peak_bytes=cardr["card_peak_bytes"],
                   card_before_bytes=cardr["card_before_bytes"], peak_rel=peak_rel,
                   ops_differing=diff, launches=cardr["launches"],
                   kernels=(meta["kernels"], cardr["kernels"]), ms=cardr["ms"],
                   model_flops=r["model_flops"],
                   tflops=r["model_flops"] / (cardr["ms"] * 1e-3) / 1e12,
                   bf16_peak_share=share)
        res["counts"][name] = row
        log(f"14b {name}: meta / card flops {meta['flops']:.6e} / {cardr['flops']:.6e}, "
            f"vpu {meta['vpu_flops']:.6e} / {cardr['vpu_flops']:.6e}, hbm "
            f"{meta['hbm_bytes']:.6e} / {cardr['hbm_bytes']:.6e}, ops {meta['n_ops']} / "
            f"{cardr['n_ops']}, args {meta['argument_bytes']} / {cardr['argument_bytes']}; "
            f"peak {meta['peak_bytes'] / 1e9:.3f} GB against max_memory_allocated "
            f"{cardr['card_peak_bytes'] / 1e9:.3f} GB ({peak_rel:.4f}; before the step "
            f"{cardr['card_before_bytes'] / 1e9:.3f} GB); launches {cardr['launches']}; "
            f"ops differing {diff}")
        log(f"14b {name} warm ({card}): {cardr['ms']:.2f} ms, "
            f"{row['tflops']:.1f} TFLOP/s of model flops, {share:.4f} of the bf16 peak")
        bad = []
        if meta["flops"] != cardr["flops"] or meta["argument_bytes"] != cardr["argument_bytes"]:
            bad.append("flops or argument_bytes differ")
        if any(op in matmuls for op in diff):
            bad.append("a matmul differs")
        if peak_rel > DRYRUN_PEAK_REL:
            bad.append(f"peak {peak_rel:.4f} off")
        if cardr["launches"] != want:
            bad.append(f"launches {cardr['launches']}, want {want}")
        if not cardr["finite"]:
            bad.append("non-finite output")
        if bad:
            fail(f"14b {name}: {bad}")
    log(f"14b done in {time.perf_counter() - t1:.1f} s")

    # (c)
    t2 = time.perf_counter()
    ranks = run_ranks(dryrun_mesh_rank, int(np.prod(c["mesh"])), list(c["variants"]))
    res["mesh"] = {}
    row_bytes = c["train"][0] * c["train"][1] * 2560 * 4
    for i, (remat, lowp) in enumerate(c["variants"]):
        name = remat + (" lowp" if lowp else "")
        for r, rk in enumerate(ranks):
            v = rk[i]
            if v["record"] != v["dry"]:
                fail(f"14c {name} rank {r}: record {v['record']} against the dry run's "
                     f"{v['dry']}")
            if v["launches"]["flash_attention"] != 2 * 2 * c["n_layers"]:
                fail(f"14c {name} rank {r}: launches {v['launches']}")
        v = ranks[0][i]
        res["mesh"][name] = {k: [rk[i][k] for rk in ranks]
                             for k in ("loss", "grad_norm", "peak_gb", "ms", "launches")}
        res["mesh"][name]["record"] = v["record"]
        log(f"14c {name} ({card}): loss {v['loss']:.7f}, grad norm {v['grad_norm']:.7f}, "
            f"all-reduce {v['record']['counts']['all-reduce']} / "
            f"{v['record']['bytes']['all-reduce']} B "
            f"{json.dumps(v['record']['dtype_bytes']['all-reduce'])}, all-gather "
            f"{v['record']['counts']['all-gather']}, peak "
            f"{[round(rk[i]['peak_gb'], 3) for rk in ranks]} GB, warm step "
            f"{[round(rk[i]['ms'], 1) for rk in ranks]} ms a rank")
    full, comm = ranks[0][0], ranks[0][2]
    saved = full["record"]["counts"]["all-reduce"] - comm["record"]["counts"]["all-reduce"]
    saved_b = full["record"]["bytes"]["all-reduce"] - comm["record"]["bytes"]["all-reduce"]
    if saved != 2 * c["n_layers"] or saved_b != 2 * c["n_layers"] * row_bytes:
        fail(f"14c comm saved {saved} all-reduces ({saved_b} B), want "
             f"{2 * c['n_layers']} ({2 * c['n_layers'] * row_bytes} B)")
    f32, low = full["record"]["dtype_bytes"]["all-reduce"], ranks[0][3]["record"][
        "dtype_bytes"]["all-reduce"]
    moved = f32.get("torch.float32", 0) - low.get("torch.float32", 0)
    if not moved or 2 * low.get("torch.bfloat16", 0) != moved:
        fail(f"14c lowp: bf16 bytes {low} against the f32 bytes it replaced {moved}")
    for i in (1, 2):
        v = ranks[0][i]
        for k in ("loss", "grad_norm"):
            if abs(v[k] - full[k]) > DRYRUN_REMAT_REL * abs(full[k]):
                fail(f"14c {v['remat']} {k} {v[k]} against full's {full[k]}")
        res["mesh"][v["remat"]]["bits_equal_full"] = (
            v["loss_bits"] == full["loss_bits"] and v["gnorm_bits"] == full["gnorm_bits"])
    lw = ranks[0][3]
    if (abs(lw["loss"] - full["loss"]) > DRYRUN_LOWP_LOSS_REL * abs(full["loss"])
            or abs(lw["grad_norm"] - full["grad_norm"])
            > DRYRUN_LOWP_GNORM_REL * abs(full["grad_norm"])):
        fail(f"14c lowp: loss {lw['loss']} / grad norm {lw['grad_norm']} against "
             f"{full['loss']} / {full['grad_norm']}")
    res["comm_saved"] = {"all_reduces": saved, "bytes": saved_b}
    res["lowp"] = {"bf16_bytes": low.get("torch.bfloat16", 0), "f32_bytes_replaced": moved,
                   "loss_rel": abs(lw["loss"] - full["loss"]) / abs(full["loss"]),
                   "gnorm_rel": abs(lw["grad_norm"] - full["grad_norm"]) / abs(full["grad_norm"])}
    log(f"14c: comm saved {saved} all-reduces ({saved_b} B); lowp bf16 "
        f"{res['lowp']['bf16_bytes']} B for {moved} f32 B, loss rel "
        f"{res['lowp']['loss_rel']:.2e}, grad norm rel {res['lowp']['gnorm_rel']:.2e}; dots / comm "
        f"bits equal full's: {res['mesh']['dots']['bits_equal_full']} / "
        f"{res['mesh']['comm']['bits_equal_full']}")
    log(f"14c done in {time.perf_counter() - t2:.1f} s")
    return res


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
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    from repro_torch.kernels.decode_attention import ref as decode_ref
    from repro_torch.kernels.flash_attention import kernel as attn_kernel
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
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rglru as rglru_mod
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
    # every tensor-core instance (D 64, 128, 256; with and without the
    # softcap) holds HGMMA; and the D 256 instances' resources: registers and
    # local (spilled) bytes from the binary, dynamic shared memory and blocks
    # an SM from the occupancy calculator
    fa_usage = res_usage(build.library_path("flash_attention"), cuobjdump)
    hgmma_by_instance, d256 = {}, {}
    for d in (64, 128, 256):
        for cap in (0, 1):
            key = f"flash_fwd_wgmmaILi{d}ELb{cap}E"
            hgmma_by_instance[f"D{d} cap{cap}"] = sum(
                "HGMMA" in t for _, t, _ in sass_function(sass, key))
    for name, key, dt in (("bf16 wgmma", "flash_fwd_wgmmaILi256ELb1E", torch.bfloat16),
                          ("f32 fma", "flash_fwd_fmaIfLi256E", torch.float32)):
        use = next((u for f, u in fa_usage.items() if key in f), None)
        d256[name] = {**attn_kernel.launch_shape(256, dt), "res_usage": use}
    log(f"flash_attention HGMMA a tensor-core instance: "
        f"{json.dumps(hgmma_by_instance)} (limit: at least 1 each); head dim "
        f"256: {json.dumps(d256)} (the bf16 instance: a 1-stage K/V ring, "
        f"99,344 B a block, two blocks an SM)")
    if min(hgmma_by_instance.values()) == 0:
        fail(f"a tensor-core instance has no HGMMA: {hgmma_by_instance}")
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
                                          window=kw["window"],
                                          prefix=kw.get("prefix", 0), device=dev)
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
    # head dim 256 (the tensor-core instance's 1-stage ring; f32 on FMA): a
    # small case, then the phase-10 cells' own shapes: recurrentgemma's
    # local layer (MQA, window 2048) and paligemma's prefix-LM layer
    cases += [dict(B=1, Sq=300, Sk=300, Hq=4, Hkv=1, D=256, window=0, cap=0.0,
                   causal=True),
              dict(B=1, Sq=4600, Sk=4600, **RGLRU_ATTN),
              dict(B=1, Sq=4600, Sk=4600, **PREFIX_ATTN)]
    # phase 11b's shapes: gemma3-4b's local (window 1024) and global layers
    cases += [dict(B=1, Sq=4096, Sk=4096, window=window, **GEMMA3_ATTN)
              for window in (1024, 0)]
    # phase 12b's shapes: a model rank's heads of those layers (4 of 8, 2 of 4)
    cases += [dict(B=1, Sq=4096, Sk=4096, window=window, **TP_ATTN)
              for window in (1024, 0)]
    worst = {}
    for c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v = qkv(c["B"], c["Sq"], c["Sk"], c["Hq"], c["Hkv"], c["D"], dtype)
            err, _ = compare(q, k, v, c, scale=c.get("scale", 0.0),
                             softcap=c["cap"], causal=c["causal"],
                             window=c["window"], prefix=c.get("prefix", 0))
            worst[dname] = max(worst.get(dname, 0.0), err)
            del q, k, v
        if c["Sq"] == c["Sk"] and c["D"] in (64, 128, 256):   # the wgmma instance
            probe(c["B"], c["Sq"], c["Hq"], c["Hkv"], c["D"], c, scale=c.get("scale", 0.0),
                  softcap=c["cap"], causal=c["causal"], window=c["window"],
                  prefix=c.get("prefix", 0))
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
            out, aux, cache = self._block(kind, p, x, **kw)
            if x.shape[1] > 1:
                self.residual.append(float(out.abs().mean(dtype=torch.float32)))
            return out, aux, cache

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
            self.layers.append(dict(window=kw.get("window", 0),
                                    prefix=kw.get("prefix", 0), max_err=max_err,
                                    err_over_limit=ratio, mean_abs_ref=mean_ref))
            return o_p

    class DecodeLockstep:
        """Serves the plain decode attention and runs the kernel beside it
        on each call's q and caches (each attention layer's decode step),
        holding the kernel to decode_error_limit on what the model really
        decodes. Its kernel launches are comparisons."""

        def __init__(self):
            self.err_over_limit = []

        def attention(self, q, k_cache, v_cache, *, group=None, **kw):
            if group is not None:
                fail("the decode lockstep serves one device, not a sequence group")
            o_p = decode_ref.decode_attention(q, k_cache, v_cache, **kw)
            o_k = decode_kernel.decode_attention(q, k_cache, v_cache, **kw)
            err = float((o_k.float() - o_p.float()).abs().max())
            self.err_over_limit.append(err / decode_error_limit(v_cache))
            return o_p

    decode_launches, decode_lockstep = {}, {}

    def serve_cell(cell, plain_swap, plain_launches=None, probe=None,
                   first_swap=None) -> tuple[dict, dict]:
        """Serve the cell through its kernel (inside ``first_swap``, if
        given), then through the kernel's plain version (``plain_swap``; it
        launches ``plain_launches``, by default none), then warm, then
        ``probe(cfg, serve kwargs, first run)`` if given, whose readings join
        the stats. A cell with ``n_prefix`` serves that many prefix
        embeddings (seeded normal, bf16) before each prompt. Returns (stats,
        launches of the first run)."""
        cfg = cell_config(cell)
        name = cell["kernel"]
        log(f"serve: {cfg.name} at published widths ({json.dumps(dataclasses.asdict(cfg))}); "
            f"reduced: {cell['reduced']}")
        kw = dict(batch=cell["batch"], prompt_len=cell["prompt_len"],
                  new_tokens=cell["new_tokens"], seed=cell["seed"], device=dev,
                  log=log)
        if cell.get("n_prefix"):
            pgen = torch.Generator(device=dev).manual_seed(cell["seed"] + 2)
            kw["prefix_embed"] = torch.randn(
                (cell["batch"], cell["n_prefix"], cfg.d_model), generator=pgen,
                device=dev).to(torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with first_swap or contextlib.nullcontext():
            first = serve(cfg, **kw)
        launches = dict(LAUNCHES)
        log(f"serve launches: {launches}")
        want = serve_launches(cfg, cell["new_tokens"])
        if launches != want:
            fail(f"{cfg.name} serve path launched {launches}, want {want} "
                 f"(one {name} per layer's prefill, one decode attention per "
                 f"attention layer's decode step)")
        params, prompts = first["params"], first["prompts"]
        B, N, V = cell["batch"], cell["new_tokens"], cfg.vocab_size
        lg = first["prefill_logits"]
        if lg.shape != (B, V) or not bool(torch.isfinite(lg).all()):
            fail(f"prefill logits {tuple(lg.shape)} not finite or misshaped")
        toks = first["tokens"]
        if toks.shape != (B, N) or int(toks.min()) < 0 or int(toks.max()) >= V:
            fail(f"generated tokens {tuple(toks.shape)} out of range")

        # the same model, params and prompts through the kernel's plain
        # version and the plain decode attention, the decode kernel in
        # lockstep beside it
        dlock = DecodeLockstep()
        with plain_swap, swapped(attention_mod, "decode_attention", dlock.attention):
            reset_launches()
            plain = serve(cfg, **kw, params=params, prompts=prompts)
        plain_want = {**(plain_launches or {k: 0 for k in launches}),
                      "decode_attention": want["decode_attention"]}
        if LAUNCHES != plain_want:
            fail(f"the plain run launched {dict(LAUNCHES)}, want {plain_want}")
        ratios = dlock.err_over_limit
        log(f"decode lockstep ({cfg.name}, the kernel on each attention layer's "
            f"served q and caches, {len(ratios)} calls): max |err|/limit "
            f"{max(ratios, default=0.0):.3g} (limit 1)")
        if len(ratios) != want["decode_attention"] or not all(r <= 1 for r in ratios):
            fail(f"decode_attention disagrees with its plain version on a served "
                 f"{cfg.name} decode step ({len(ratios)} calls seen, want "
                 f"{want['decode_attention']})")
        decode_launches[cfg.name] = launches["decode_attention"]
        decode_lockstep[cfg.name] = max(ratios, default=0.0)
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
            if cell.get("logits_gate", True):
                fail("prefill logits of the kernel path disagree with the plain path")
            log(f"serve: {cfg.name}'s logits are a reading, not its gate "
                f"({cell['logits_gate_reason']})")
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
        {"decode_attention": 0, "flash_attention": gcfg.n_layers, "ssm_scan": 0,
         "staging_pack": 0})
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
        {"decode_attention": 0, "flash_attention": 0, "ssm_scan": mcfg.n_layers,
         "staging_pack": 0},
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

    # -- 5b. the decode-attention kernel at the main path's decode shapes -------
    decode_shapes = decode_attention_on_the_card(dev, time_ms)
    log(f"decode attention done at {time.perf_counter() - t_start:.1f} s")

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

    # -- 8. train ------------------------------------------------------------------
    from repro_torch.data import DataConfig, SyntheticLM, batch_to_device
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.train import stage_egress
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.optimizer import global_norm
    from repro_torch.train import TrainConfig, TrainSetup
    from repro_torch.train import train_step as train_step_mod

    gc.collect()
    torch.cuda.empty_cache()

    class EventTimes:
        """CUDA events around every call of ``module.name`` inside the block;
        ``ms()`` is their summed device time since the last ``reset()``."""

        def __init__(self, module, name: str):
            self.module, self.name, self.pairs = module, name, []

        def reset(self) -> None:
            self.pairs = []

        def ms(self) -> float:
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in self.pairs)

        @contextlib.contextmanager
        def attached(self):
            inner = getattr(self.module, self.name)

            def timed(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = inner(*a, **kw)
                end.record()
                self.pairs.append((start, end))
                return out

            with swapped(self.module, self.name, timed):
                yield

    tcfg = dataclasses.replace(cell_config(TRAIN), remat="full")
    if tcfg.compute_dtype != "bfloat16" or tcfg.param_dtype != "float32":
        fail(f"train cell dtypes {tcfg.compute_dtype}/{tcfg.param_dtype}")
    tsetup = TrainSetup(Model(tcfg), TrainConfig(
        peak_lr=TRAIN["peak_lr"], warmup_steps=TRAIN["warmup_steps"],
        total_steps=TRAIN["steps"], egress="grads_int8",
        egress_blocks=TRAIN["egress_blocks"], microbatches=TRAIN["microbatches"]))
    log(f"train: {tcfg.name} at published widths ({json.dumps(dataclasses.asdict(tcfg))}); "
        f"{tcfg.param_count()} params; reduced: {TRAIN['reduced']}")
    data = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size, seq_len=TRAIN["seq_len"],
                                  global_batch=TRAIN["global_batch"], seed=TRAIN["seed"])
                       ).batches()
    tbatches = [batch_to_device(next(data), dev) for _ in range(TRAIN["steps"])]
    torch.cuda.reset_peak_memory_stats()
    tstate = tsetup.init_state(TRAIN["seed"], dev)
    want_step = {"decode_attention": 0,
                 "flash_attention": tcfg.n_layers * TRAIN["microbatches"] * 2,
                 "ssm_scan": 0, "staging_pack": 1}

    # step 1 against the plain attention path. Step 0's LR is 0, so step 1
    # computes its gradients at the initial params: both runs take them here
    t0 = time.perf_counter()
    reset_launches()
    loss_k, _, grads_k = tsetup.loss_and_grads(tstate["params"], tbatches[1])
    grads_k = [g.cpu() for g in tree_leaves(grads_k)]
    kernel_launches = dict(LAUNCHES)
    reset_launches()
    with swapped(attention_mod, "gqa_attention", ops.gqa_attention_ref):
        loss_p, _, grads_p = tsetup.loss_and_grads(tstate["params"], tbatches[1])
    plain_launches = dict(LAUNCHES)
    if kernel_launches["flash_attention"] != want_step["flash_attention"] or \
            plain_launches["flash_attention"] != 0:
        fail(f"step-1 comparison launched {kernel_launches} (kernel) and "
             f"{plain_launches} (plain)")
    gnorm_p = float(global_norm(grads_p))
    names = [".".join(str(p) for p in path) for path, _ in
             _paths(tsetup.state_specs()["params"])]
    grad_rel = {}
    for name, gk, gp in zip(names, grads_k, tree_leaves(grads_p)):
        gp32 = gp.float()
        grad_rel[name] = float((gk.to(dev).float() - gp32).norm() / gp32.norm())
    loss_plain = float(loss_p)
    del grads_p, grads_k
    gc.collect()
    torch.cuda.empty_cache()
    worst_leaf = max(grad_rel, key=grad_rel.get)
    attn_rel = {k: v for k, v in grad_rel.items() if ".attn." in k}
    log(f"train step 1, kernel vs plain attention path ({time.perf_counter() - t0:.1f} s): "
        f"loss {float(loss_k)!r} vs {loss_plain!r}; per-leaf gradient relative "
        f"(Frobenius) error: worst {worst_leaf} {grad_rel[worst_leaf]:.3g} (limit "
        f"{TRAIN_GRAD_REL}); attention projections {json.dumps(attn_rel)}")
    if not all(v <= TRAIN_GRAD_REL for v in grad_rel.values()):
        fail(f"a gradient of step 1 differs from the plain path's: {grad_rel}")

    # the run: 4 steps, each one's egress staged through sink, staging, SAVIME
    flash_t = EventTimes(fa_kernel, "flash_attention")
    vjp_t = EventTimes(attn_ref, "attention_ref_vjp")
    adamw_t = EventTimes(train_step_mod, "adamw_update")
    savime = SavimeServer().start()
    staging = StagingServer(savime.addr, mem_capacity=mem_capacity,
                            disk_dir=str(disk_dir), send_threads=2).start()
    train_rows, staged = [], []
    try:
        sink = InTransitSink(staging.addr, InTransitConfig(
            io_threads=2, tar_prefix="train", codec="none"))
        try:
            step_fn = tsetup.step_fn()
            torch.cuda.synchronize()
            reset_launches()
            with flash_t.attached(), vjp_t.attached(), adamw_t.attached():
                for i, batch in enumerate(tbatches):
                    for tm_ in (flash_t, vjp_t, adamw_t):
                        tm_.reset()
                    before = dict(LAUNCHES)
                    t_step = time.perf_counter()
                    tstate, metrics, egress = step_fn(tstate, batch)
                    torch.cuda.synchronize()
                    step_ms = (time.perf_counter() - t_step) * 1e3
                    staged.append(stage_egress(sink, egress, int(tstate["step"])))
                    row = dict(step=i, step_ms=step_ms, loss=float(metrics["loss"]),
                               grad_norm=float(metrics["grad_norm"]),
                               lr=float(metrics["lr"]), flash_ms=flash_t.ms(),
                               plain_backward_ms=vjp_t.ms(), adamw_ms=adamw_t.ms(),
                               launches={k: LAUNCHES[k] - before[k] for k in LAUNCHES})
                    train_rows.append(row)
                    log(f"train step {i}: {json.dumps(row)}")
            train_launches = dict(LAUNCHES)
            train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
            sink.flush(timeout=600)
        finally:
            sink.close()
        with AnalysisSession(savime.addr) as an:
            back = {name: an.execute(tar(f"train_{name}").attr("v").select()).array
                    for name in ("diag", "grad_blocks", "grad_scales")}
    finally:
        staging.stop()
        savime.stop()
    n_steps = TRAIN["steps"]
    want_run = {k: v * n_steps for k, v in want_step.items()}
    if train_launches != want_run or any(r["launches"] != want_step for r in train_rows):
        fail(f"train run launched {train_launches} "
             f"({[r['launches'] for r in train_rows]} a step), want {want_step} a step")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in train_rows):
        fail(f"a train step's loss or grad_norm is not finite: {train_rows}")
    step1 = train_rows[1]
    loss_err = abs(step1["loss"] - loss_plain) / abs(loss_plain)
    gnorm_err = abs(step1["grad_norm"] - gnorm_p) / gnorm_p
    log(f"train step 1 against the plain path: loss {step1['loss']!r} vs {loss_plain!r} "
        f"(relative {loss_err:.3g}, limit {TRAIN_LOSS_REL}); grad_norm "
        f"{step1['grad_norm']!r} vs {gnorm_p!r} (relative {gnorm_err:.3g}, limit "
        f"{TRAIN_GNORM_REL}); lr {step1['lr']}")
    if not (loss_err <= TRAIN_LOSS_REL and gnorm_err <= TRAIN_GNORM_REL):
        fail("step 1's loss or grad_norm differs from the plain path's")
    if step1["lr"] <= 0 or train_rows[0]["lr"] != 0.0:
        fail(f"lr {[r['lr'] for r in train_rows]}: step 0 must be 0, step 1 > 0")
    readback_equal = all(
        back[name].shape[0] == n_steps and all(
            back[name][i].tobytes() == staged[i][name].tobytes() for i in range(n_steps))
        for name in ("diag", "grad_blocks", "grad_scales"))
    diag_is_step = all(
        staged[i]["diag"].tobytes() == np.float32([r["loss"], r["grad_norm"]]).tobytes()
        for i, r in enumerate(train_rows))
    log(f"train: SAVIME holds {back['diag'].shape[0]} steps of diag {back['diag'].shape}, "
        f"grad_blocks {back['grad_blocks'].shape} {back['grad_blocks'].dtype}, scales "
        f"{back['grad_scales'].shape}; read back equal to what each step staged: "
        f"{readback_equal}; each diag equal to the step's loss and grad_norm: {diag_is_step}")
    if not (readback_equal and diag_is_step):
        fail("SAVIME's train read-back differs from what the steps returned")
    warm = train_rows[1:]
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    train_stats = {
        "config": f"{tcfg.name} n_layers={tcfg.n_layers} remat={tcfg.remat}",
        "reduced": TRAIN["reduced"],
        "steps": train_rows,
        "warm_step_ms": float(np.median([r["step_ms"] for r in warm])),
        "tokens_per_step": tokens,
        "peak_mem_gb": train_peak_gb,
        "flash_ms_per_step": float(np.median([r["flash_ms"] for r in warm])),
        "plain_backward_ms_per_step": float(np.median([r["plain_backward_ms"] for r in warm])),
        "adamw_ms_per_step": float(np.median([r["adamw_ms"] for r in warm])),
        "step1_loss_rel_err": loss_err, "step1_grad_norm_rel_err": gnorm_err,
        "step1_grad_rel_err_max": grad_rel[worst_leaf], "step1_grad_rel_err": grad_rel,
    }
    train_stats["tokens_per_s"] = tokens / (train_stats["warm_step_ms"] / 1e3)
    log(f"train (warm, median of steps 2-4): {json.dumps({k: v for k, v in train_stats.items() if k not in ('steps', 'step1_grad_rel_err')})}")
    del tstate, tbatches, metrics, egress
    gc.collect()
    torch.cuda.empty_cache()

    # 8b. recovery: the example twin on the card, in this process
    example = ROOT / "examples" / "torch_train_with_intransit.py"
    argv = sys.argv
    sys.argv = [str(example), "--device", "cuda", "--steps", str(RECOVERY_STEPS)]
    try:
        reset_launches()
        t0 = time.perf_counter()
        ex = runpy.run_path(str(example), run_name="__main__")
        recovery_s = time.perf_counter() - t0
        recovery_launches = dict(LAUNCHES)
    finally:
        sys.argv = argv
    n_layers_smoke = ex["cfg"].n_layers
    want_rec = {"decode_attention": 0,
                "flash_attention": n_layers_smoke * RECOVERY_STEPS, "ssm_scan": 0,
                "staging_pack": RECOVERY_STEPS}
    rec = {"steps": RECOVERY_STEPS, "seconds": recovery_s,
           "restarts": ex["sup"].restarts, "loss_first": ex["losses"][0],
           "loss_last": ex["losses"][-1], "savime_diag_rows": int(ex["diag"].shape[0]),
           "launches": recovery_launches}
    log(f"train recovery (examples/torch_train_with_intransit.py on {kind}): {json.dumps(rec)}")
    if not (rec["restarts"] == 1 and rec["loss_last"] < rec["loss_first"]
            and rec["savime_diag_rows"] == RECOVERY_STEPS and recovery_launches == want_rec):
        fail(f"the recovery run: {rec}, want launches {want_rec}")
    train_stats["recovery"] = rec
    log(f"train done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9. the paper's transports from the card ----------------------------------
    t9 = time.perf_counter()
    transports = transports_from_the_card(dev, MESH, mem_capacity, disk_dir)
    log(f"transports done in {time.perf_counter() - t9:.1f} s: "
        f"{json.dumps({k: {m: v[m] for m in ('raw_mb_per_s', 'stage_ms_median', 'launches', 'replays') if m in v} for k, v in transports.items()})}")

    # -- 10. the other architectures: RG-LRU, MoE, prefix-LM ----------------------
    # Estimated before its first run on the card, from phase 4's readings
    # (prefill ~160 ms for 4 gemma2 layers): ~60 s. recurrentgemma ~25 s (4
    # serves of ~3 s, the lockstep's f32 plain attention on 12 layers ~6 s),
    # llama4 ~10 s (its f32-temporary init of 18.6 B bf16 params; decode
    # reads all 128 experts' 32 GB a moe step), paligemma ~8 s, the three
    # attention shapes' checks and times ~15 s.
    t10 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    class PlanRecorder:
        """Wraps moe.route in the cell's first run: keeps each call's
        dispatch plan, and recounts its drops on the host from the same
        router probabilities (each choice past its expert's capacity)."""

        def __init__(self):
            self.calls = []
            self._route = moe_mod.route

        def route(self, router, xg, **kw):
            plan = self._route(router, xg, **kw)
            probs = plan["probs"].cpu().numpy()
            G, T, E = probs.shape
            top = np.argsort(-probs, axis=-1, kind="stable")[..., :kw["top_k"]]
            counts = np.stack([np.bincount(t.reshape(-1), minlength=E) for t in top])
            self.calls.append(dict(
                groups=G, tokens=T, capacity=plan["C"],
                token_for_slot=list(plan["token_for_slot"].shape),
                slots_filled=int((plan["w_for_slot"] > 0).sum()),
                dropped=plan["dropped"].tolist(),
                host_recount=np.maximum(counts - plan["C"], 0).sum(-1).tolist()))
            return plan

    def attention_nudge_probe(cfg, kw, first) -> dict:
        """A reading, not a check: how far the served logits move when every
        attention layer's kernel output is one bf16 step off in every
        ATTN_NUDGE_EVERY-th element. This is what the logits gate asks of a
        kernel that rounds otherwise than the plain version."""
        def nudged(q, k, v, **akw):
            o = ops.gqa_attention(q, k, v, **akw)
            o.view(-1).view(torch.int16)[::ATTN_NUDGE_EVERY] += 1
            return o

        with swapped(attention_mod, "gqa_attention", nudged):
            out = serve(cfg, **kw, params=first["params"], prompts=first["prompts"])
        lg, lg_n = first["prefill_logits"].float(), out["prefill_logits"].float()
        err = float((lg_n - lg).abs().max())
        agree = int((out["tokens"] == first["tokens"]).sum())
        log(f"nudge probe ({cfg.name}): one bf16 step in every {ATTN_NUDGE_EVERY}th "
            f"attention output of every layer moves the prefill logits by "
            f"max|err| {err:.3g} against mean|logit| {float(lg.abs().mean()):.3g} "
            f"(the gate: {LOGITS_REL}*mean|logit|); greedy tokens agreeing "
            f"{agree}/{out['tokens'].numel()}")
        return {"nudge_logits_max_abs_err": err, "nudge_tokens_agree": agree}

    def layer_ms(fn, cell, cfg) -> float:
        """CUDA-event time of one mixer call on the cell's prefill shape."""
        x = randn(cell["batch"], cell["prompt_len"], cfg.d_model).to(torch.bfloat16)
        with torch.inference_mode():
            return time_ms(lambda: fn(x))

    def rglru_probe(cfg, kw, first) -> dict:
        p = first["params"]["scan"]["0:rglru"][0]["rglru"]
        ms = layer_ms(lambda x: rglru_mod.rglru_block(p, x, cfg=cfg), SERVE_RGLRU, cfg)
        log(f"rglru mixer (one layer, B={SERVE_RGLRU['batch']} "
            f"S={SERVE_RGLRU['prompt_len']}, d_rnn {cfg.d_rnn}): {ms:.3f} ms")
        return {"rglru_mixer_ms": ms, **attention_nudge_probe(cfg, kw, first)}

    def moe_probe(cfg, kw, first) -> dict:
        p = first["params"]["rem"]["1:moe"]["moe"]
        ms = layer_ms(lambda x: moe_mod.moe_block(p, x, cfg=cfg), SERVE_MOE, cfg)
        log(f"moe layer (router, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
            f"shared expert; B={SERVE_MOE['batch']} S={SERVE_MOE['prompt_len']}): "
            f"{ms:.3f} ms")
        return {"moe_layer_ms": ms}

    arch_launches = {}
    for cell, cell_probe in ((SERVE_RGLRU, rglru_probe), (SERVE_MOE, moe_probe),
                             (SERVE_PREFIX, attention_nudge_probe)):
        acfg = cell_config(cell)
        want = prefill_launches(acfg)
        lock = AttentionLockstep()
        recorder = PlanRecorder() if acfg.moe else None
        stats, launches = serve_cell(
            cell, swapped(attention_mod, "gqa_attention", lock.attention), want,
            cell_probe, swapped(moe_mod, "route", recorder.route) if recorder else None)
        att = lock.layers
        log(f"lockstep ({acfg.name} prefill, the kernel on each attention layer's "
            f"served q, k, v): max |err|/limit "
            f"{[round(a['err_over_limit'], 3) for a in att]} (limit 1)")
        if len(att) != want["flash_attention"] or any(
                not a["err_over_limit"] <= 1 for a in att):
            fail(f"flash_attention disagrees with its plain version on a served "
                 f"{acfg.name} layer's input ({len(att)} layers seen, want "
                 f"{want['flash_attention']})")
        stats["lockstep"] = att
        # a cell whose logits are a reading still fails if they moved more
        # than the nudge probe moves them: its rounding would then not be
        # what sets the gap
        if not cell.get("logits_gate", True) and not (
                stats["logits_max_abs_err"] <= LOGITS_REL * stats["logits_mean_abs"]
                or stats["logits_max_abs_err"] <= 2 * stats["nudge_logits_max_abs_err"]):
            fail(f"{acfg.name}: the kernel path's logits lie "
                 f"{stats['logits_max_abs_err']:.3g} from the plain path's, more "
                 f"than twice the nudge probe's {stats['nudge_logits_max_abs_err']:.3g}")
        if recorder is not None:
            calls = recorder.calls
            log(f"moe dispatch plan, prefill: {json.dumps(calls[0])}; decode "
                f"steps: {len(calls) - 1}, dropped {sum(sum(c['dropped']) for c in calls[1:])}")
            bad = [c for c in calls if c["dropped"] != c["host_recount"]]
            if len(calls) != cell["new_tokens"] or bad or calls[0]["tokens"] != cell["prompt_len"]:
                fail(f"moe dispatch plan: {len(calls)} routings (want "
                     f"{cell['new_tokens']}), drops disagreeing with the host "
                     f"recount: {bad[:2]}")
            stats["dispatch_prefill"] = calls[0]
            stats["dispatch_decode_dropped"] = sum(sum(c["dropped"]) for c in calls[1:])
        serve_stats[cell["arch"]] = stats
        arch_launches[cell["arch"]] = launches["flash_attention"]
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{acfg.name} cell done at {time.perf_counter() - t_start:.1f} s")

    # the flash kernel at the new cells' shapes: against its plain version,
    # the mask probe, then its time, the plain version's, the bound and
    # scaled_dot_product_attention's (a boolean mask for the window and the
    # prefix; no softcap in these configs)
    arch_shapes = {}
    for what, shape, cell in (("recurrentgemma-9b local", RGLRU_ATTN, SERVE_RGLRU),
                              ("paligemma-3b prefix", PREFIX_ATTN, SERVE_PREFIX),
                              ("llama4-maverick global", MOE_ATTN, SERVE_MOE)):
        Hq, Hkv, D = shape["Hq"], shape["Hkv"], shape["D"]
        window, prefix = shape["window"], shape.get("prefix", 0)
        q, k, v = qkv(Bs, S, S, Hq, Hkv, D, torch.bfloat16)
        akw = dict(scale=D ** -0.5, softcap=0.0, causal=True, window=window,
                   prefix=prefix)
        label = f"{what} B={Bs} S={S} Hq={Hq} Hkv={Hkv} D={D}"
        err, mean_ref = compare(q, k, v, label, **akw)
        probe_r = probe(Bs, S, Hq, Hkv, D, label, **akw)
        qp_, kp_ = torch.arange(S, device=dev)[:, None], torch.arange(S, device=dev)[None, :]
        mask = None
        if window or prefix:
            mask = (kp_ <= qp_) & ((qp_ - kp_ < window) if window else True)
            mask = mask | (kp_ < prefix)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = dict(
            ms=time_ms(lambda: ops.gqa_attention(q, k, v, **akw)),
            plain_ms=time_ms(lambda: ops.gqa_attention_ref(q, k, v, **akw), reps=1),
            library_ms=time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                            is_causal=mask is None, scale=D ** -0.5,
                                            enable_gqa=True)),
            max_abs_err=err, mean_abs_ref=mean_ref, mask_probe_err_over_limit=probe_r)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            Bs, S, Hq, Hkv, D, True, window, "bfloat16", prefix)
        arch_shapes[what] = row
        log(f"time {label} (window {window}, prefix {prefix}, cap 0): kernel "
            f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_by']}), "
            f"scaled_dot_product_attention {row['library_ms']:.3f} ms")
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    log(f"architectures done in {time.perf_counter() - t10:.1f} s: flash launches "
        f"a prefill {json.dumps(arch_launches)}; "
        + json.dumps({a: {m: serve_stats[a][m] for m in (
            "prefill_ms", "decode_p50_ms", "decode_p99_ms", "peak_mem_gb",
            "logits_max_abs_err", "logits_mean_abs")}
            for a in arch_launches}))

    # -- 11. data-parallel training, the ranks sharing the card --------------------
    gc.collect()
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    dp = data_parallel_on_the_card(card, disk_dir)
    log(f"data parallel done in {time.perf_counter() - t11:.1f} s")

    # -- 12. serving on a (data, model) mesh, the ranks sharing the card ---------
    gc.collect()
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    tp = serve_on_a_mesh(card, dev)
    # the kernels at a rank's shapes: 12b's attention (GQA 4/2, D 256, local
    # and global) and falcon-mamba-7b's scan at model 2 (di 4096): each
    # against its plain version, then its time beside the plain version's,
    # its bound and the library call's
    tp_shapes = {}
    for window in (1024, 0):
        c = dict(B=1, S=4096, window=window, **TP_ATTN)
        q, k, v = qkv(1, c["S"], c["S"], c["Hq"], c["Hkv"], c["D"], torch.bfloat16)
        akw = dict(scale=c["D"] ** -0.5, softcap=0.0, causal=True, window=window)
        label = f"12b rank B=1 S={c['S']} Hq={c['Hq']} Hkv={c['Hkv']} D={c['D']} window {window}"
        err, mean_ref = compare(q, k, v, label, **akw)
        qp_, kp_ = torch.arange(c["S"], device=dev)[:, None], torch.arange(c["S"], device=dev)[None, :]
        mask = ((kp_ <= qp_) & (qp_ - kp_ < window)) if window else None
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = dict(ms=time_ms(lambda: ops.gqa_attention(q, k, v, **akw)),
                   plain_ms=time_ms(lambda: ops.gqa_attention_ref(q, k, v, **akw), reps=1),
                   library_ms=time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                   is_causal=mask is None,
                                                   scale=c["D"] ** -0.5, enable_gqa=True)),
                   max_abs_err=err, mean_abs_ref=mean_ref)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            1, c["S"], c["Hq"], c["Hkv"], c["D"], True, window, "bfloat16")
        tp_shapes[f"flash {'local' if window else 'global'}"] = row
        log(f"time {label} (cap 0; {card}): kernel {row['ms']:.3f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
            f"scaled_dot_product_attention {row['library_ms']:.3f} ms")
        del q, k, v, qt, kt, vt, mask
    ts = TP_SCAN
    sin = scan_inputs(ts["B"], ts["S"], ts["di"], ts["N"], *mixed,
                      dt_rank=mcfg.ssm.resolved_dt_rank(mcfg.d_model))
    tp_scan_err, tp_scan_mean = compare_scan(sin, f"falcon-mamba-7b rank at model 2 {ts}")
    row = dict(ms=time_ms(lambda: scan_ops.selective_scan(*sin), reps=10),
               plain_ms=time_ms(lambda: ssm_scan_ref(*sin), reps=2),
               max_abs_err=tp_scan_err, mean_abs_ref=tp_scan_mean, library_ms=None)
    row["bound_ms"], row["bound_by"], _ = scan_bound_ms(
        sin, scan_ops.selective_scan(*sin))
    tp_shapes["scan"] = row
    log(f"time ssm_scan at a model-2 rank's shape {ts} ({card}): kernel {row['ms']:.3f} "
        f"ms, plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']})")
    del sin
    torch.cuda.empty_cache()
    tp["kernel_shapes"] = tp_shapes
    log(f"serving on a mesh done in {time.perf_counter() - t12:.1f} s")

    # -- 13. training on a (pod, data, model) mesh, the ranks sharing the card ---
    gc.collect()
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    tpt = tp_train_on_the_card(card)
    log(f"training on a mesh done in {time.perf_counter() - t13:.1f} s")

    # -- 14. the dry run on the card -------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    dry = dryrun_on_the_card(card, ROOT / "build" / "dryrun_torch")
    log(f"the dry run on the card done in {time.perf_counter() - t14:.1f} s")

    def dryrun_launches(name: str) -> dict:
        """A kernel's launches in each phase-14 run (14c: a rank, 2 steps)."""
        out = {f"14b {k}": v["launches"][name] for k, v in dry["counts"].items()}
        out["14c"] = {k: [r[name] for r in v["launches"]] for k, v in dry["mesh"].items()}
        return out

    def tp_train_launches(name: str) -> dict:
        """A kernel's launches in each phase-13 run, rank by rank."""
        out = {k: [r[name] for r in v["launches"]] for k, v in tpt["meshes"].items()}
        out["13b"] = [sum(st["launches"][name] for st in r["steps"])
                      for r in tpt["full_width"]["ranks"]]
        out["13c scan grads, one device"] = [tpt["scan_grads"]["launches"][name]]
        out["13e"] = [r[name] for r in tpt["launcher"]["launches_by_rank"]]
        return out

    def mesh_launches(name: str) -> dict:
        """A kernel's launches in each phase-12 run, rank by rank."""
        return {"12a": [r[name] for r in tp["check_4x2"]["launches"]],
                "12b f32, bf16": [[r[name] for r in run]
                                  for run in tp["full_width"]["launches_by_rank"]],
                "12c": {a: [r[name] for r in v["launches"]]
                        for a, v in tp["kinds_1x2"]["kinds"].items()},
                "12d": [r[name] for r in tp["cli_2x2"]["launches_by_rank"]]}

    def dp_launches(name: str) -> dict:
        """A kernel's launches in each phase-11 run, rank by rank."""
        out = {f"11a {m}": [r[name] for r in row["launches"]]
               for m, row in dp["dp_check"].items() if m != "1x1"}
        out["11a 1x1"] = [dp["dp_check"]["1x1"]["launches"][name]]
        out["11b"] = [sum(st["launches"][name] for st in r["steps"])
                      for r in dp["full_width"]["ranks"]]
        out["11c"] = [r[name] for r in dp["launcher"]["launches_by_rank"]]
        return out

    summary = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
        "launches": fa_launches["flash_attention"],
        "launches_train": train_launches["flash_attention"],
        "launches_recovery": recovery_launches["flash_attention"],
        "launches_transports": {k: v["launches"]["flash_attention"]
                                for k, v in transports.items()},
        "launches_archs": arch_launches,
        "launches_dp": dp_launches("flash_attention"),
        "launches_mesh": mesh_launches("flash_attention"),
        "launches_tp_train": tp_train_launches("flash_attention"),
        "launches_dryrun": dryrun_launches("flash_attention"),
        "tp_shapes": {k: v for k, v in tp_shapes.items() if k != "scan"},
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
        "archs_shapes": arch_shapes,
        "hgmma_by_instance": hgmma_by_instance,
        "head_dim_256": d256,
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:51",
        "launches": scan_launches["ssm_scan"],
        "launches_train": train_launches["ssm_scan"],
        "launches_mesh": mesh_launches("ssm_scan"),
        "launches_tp_train": tp_train_launches("ssm_scan"),
        "launches_dryrun": dryrun_launches("ssm_scan"),
        "tp_shape": {**tp_shapes["scan"], "shape": TP_SCAN},
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
        "launches_train": train_launches["staging_pack"],
        "launches_recovery": recovery_launches["staging_pack"],
        "launches_transports": {k: v["launches"]["staging_pack"]
                                for k, v in transports.items()},
        "launches_dp": dp_launches("staging_pack"),
        "launches_tp_train": tp_train_launches("staging_pack"),
        "launches_dryrun": dryrun_launches("staging_pack"),
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
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "replaces": "none: the reference decodes with XLA einsums "
                    "(src/repro/models/attention.py:189)",
        "launches": decode_launches,
        "launches_mesh": mesh_launches("decode_attention"),
        "lockstep_err_over_limit": decode_lockstep,
        "shape": "B=256 T=2304 Hq=64 Hkv=8 D=128 bf16 cap=0, rows at positions "
                 "384..2207 (the qwen2-72b.batch-decode cell's layer)",
        **{m: decode_shapes["qwen2-72b batch decode"][m]
           for m in ("max_abs_err", "limit", "ms", "plain_ms", "bound_ms",
                     "library_ms", "splits", "ms_one_split")},
        "bound_by": "bytes",
        "library_call": "scaled_dot_product_attention(attn_mask, enable_gqa)",
        "shapes": decode_shapes,
    }], "serve": serve_stats, "intransit": intransit_stats, "train": train_stats,
        "data_parallel": dp, "serve_mesh": tp, "train_mesh": tpt, "dryrun": dry,
        "transports": {k: {m: v[m] for m in ("raw_mb_per_s", "stage_ms_median", "run_s",
                                             "launches", "codec", "replays",
                                             "resent_stripes", "fired", "seconds",
                                             "loss_first", "loss_last", "diag_rows",
                                             "staging") if m in v}
                       for k, v in transports.items()}}
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
