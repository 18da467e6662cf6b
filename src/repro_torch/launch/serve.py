"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Prefill a batch of prompts, then decode greedily (or by sampling at a
temperature) with the KV cache updated in place. Optionally stages
per-step decode latencies in transit (SAVIME) like a real fleet would.
The port of ``repro/launch/serve.py``, with ``--device`` (CUDA unless the
CPU is asked for). ``--mesh DxM`` or ``PxDxM`` serves on a mesh, one
process a rank (``launch.spawn``, gloo groups; on CUDA every rank on a card
of the machine, all on one when it has one), with tensor and expert
parallelism over ``model`` and the batch's rows over the DP axes; rank 0
alone logs and stages. The reference reads ``PxDxM`` as (data, model, pod)
(ROADMAP, reference caveats); the port reads it as its train launcher does.
``single`` and ``multi`` need 256 and 512 ranks, as the reference's do.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import math
import time
from typing import Any, Callable, ContextManager, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import analysis, transport
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import LAUNCHES
from repro_torch.launch.mesh import build_mesh, parse_mesh, rank_device
from repro_torch.launch.spawn import run_ranks
from repro_torch.models import Model
from repro_torch.train import ServeSetup


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _no_phase(name: str) -> ContextManager[None]:
    return contextlib.nullcontext()


def serve(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 64,
          new_tokens: int = 32, temperature: float = 0.0, seed: int = 0,
          device: str | torch.device = "cuda", params: Optional[Any] = None,
          prompts: Optional[torch.Tensor] = None,
          prefix_embed: Optional[torch.Tensor] = None,
          log: Callable[[str], None] = print,
          phase: Callable[[str], ContextManager[Any]] = _no_phase,
          sink: Optional[Any] = None, mesh: Optional[str] = None,
          seq_shard_kv: bool = False, make_sink: Optional[Callable] = None,
          keep_logits: bool = False) -> dict:
    """Serve `batch` prompts of `prompt_len` tokens and generate `new_tokens`
    tokens each. Parameters and prompts are made from `seed` unless given.
    `prefix_embed` (B, P, d_model), precomputed frontend embeddings
    (paligemma's patches), goes before each prompt; the command line passes
    none, as the reference's does.
    `phase(name)` is entered around the timed prefill ("prefill") and the
    decode loop ("decode"), e.g. to trace each with a profiler. With an
    in-transit `sink`, each decode step's latency (ms, float32) is staged
    as "decode_ms" at that step.

    `mesh` (``DxM``, ``PxDxM``, ``single`` or ``multi``; None is one
    device) serves on a mesh, one process a rank (``launch.spawn``): each
    rank draws its shard of the seed's params and serves its rows of the
    batch (all of them where the DP ranks do not divide it), with
    `seq_shard_kv` the global KV caches sequence-sharded over ``data``.
    There `params` and `sink` cannot be given: rank 0 alone logs, gathers
    the tokens and, with `make_sink` (a picklable callable returning a
    sink), stages the decode latencies.

    Returns tokens (B, new_tokens), the prefill's last-token logits (B, V),
    with `keep_logits` each decode step's (B, new_tokens - 1, V) on the
    host, prefill_ms, decode_ms (one per decode step), the kernels'
    launches and the peak device memory in GB (on a mesh rank 0's, and
    every rank's in ``launches_by_rank`` and ``peak_mem_gb_by_rank``), and
    the params and prompts used (params in the compute dtype; on a mesh
    None)."""
    kw = dict(batch=batch, prompt_len=prompt_len, new_tokens=new_tokens,
              temperature=temperature, seed=seed, device=device,
              prompts=prompts, prefix_embed=prefix_embed,
              seq_shard_kv=seq_shard_kv, keep_logits=keep_logits)
    if mesh is None:
        return _serve(cfg, params=params, log=log, phase=phase, sink=sink, **kw)
    shape, _ = parse_mesh(mesh)
    kw["make_sink"] = make_sink
    if math.prod(shape) == 1 or mesh in ("single", "multi"):
        # one process: the mesh of one rank, or the production meshes,
        # which raise here without their 256 or 512 ranks
        return serve_rank(mesh, cfg, kw, params=params, log=log, phase=phase,
                          sink=sink)
    if params is not None or sink is not None:
        raise ValueError("on a mesh each rank draws its own shard and rank 0 "
                         "makes its sink: pass no params or sink (make_sink)")
    return run_ranks(serve_rank, math.prod(shape), mesh, cfg, kw)[0]


def serve_rank(mesh_spec: str, cfg: ArchConfig, kw: dict, *,
               params: Optional[Any] = None,
               log: Callable[[str], None] = print,
               phase: Callable[[str], ContextManager[Any]] = _no_phase,
               sink: Optional[Any] = None) -> dict:
    """This rank's part of ``serve`` on the mesh ``mesh_spec``: rank 0
    logs and, with ``make_sink`` in ``kw``, makes the sink, stages, flushes
    and closes it. Returns rank 0's results (host tensors) on rank 0 and
    each rank's launches and peak memory on every rank."""
    kw = dict(kw)
    make_sink = kw.pop("make_sink", None)
    mesh = build_mesh(mesh_spec)
    root = mesh.rank == 0
    if root and make_sink is not None:
        sink = make_sink()
    try:
        out = _serve(cfg, mesh=mesh, params=params,
                     log=log if root else (lambda m: None), phase=phase,
                     sink=sink if root else None, **kw)
        if root and make_sink is not None:
            sink.flush()
    finally:
        if root and make_sink is not None:
            sink.close()
    if root and make_sink is not None:
        out["gateway"] = sink.session.stats.gateway
    if mesh.size > 1:
        for name in ("launches", "peak_mem_gb"):
            out[f"{name}_by_rank"] = [None] * mesh.size
            dist.all_gather_object(out[f"{name}_by_rank"], out[name])
        out["params"] = None
        if not root:
            return {k: out[k] for k in ("launches", "peak_mem_gb")}
        out = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
               for k, v in out.items()}
    return out


def _serve(cfg: ArchConfig, *, batch: int, prompt_len: int, new_tokens: int,
           temperature: float, seed: int, device, params, prompts,
           prefix_embed, log, phase, sink, seq_shard_kv: bool = False,
           keep_logits: bool = False, mesh=None) -> dict:
    dev = rank_device(device)
    model = Model(cfg)
    B, S, N = batch, prompt_len, new_tokens
    setup = ServeSetup(model, mesh, seq_shard_kv=seq_shard_kv, global_batch=B)
    P = 0 if prefix_embed is None else prefix_embed.shape[1]
    log(f"[serve] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
        f"{cfg.n_layers} layers on {dev}"
        + (f", mesh {mesh.shape}{' seq_shard_kv' if seq_shard_kv else ''}"
           if mesh is not None else "")
        + f", batch {B} x prompt {f'{P} prefix + ' if P else ''}{S} + {N} new")
    if dev.type == "cuda":
        torch.empty(0, device=dev)      # the allocator exists before its reset
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = dict(LAUNCHES)
    rows = setup.rows(B)
    # the global caches' slots split evenly over `data` under seq_shard_kv
    n_seq = setup.tp.seq.size if setup.tp is not None and setup.tp.seq else 1
    max_len = -(-(P + S + N) // n_seq) * n_seq
    with torch.inference_mode():
        if params is None:
            params = setup.init_params(seed, dev)
        params = model.compute_params(params)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        if prompts is None:
            prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device=dev)
        prefill = setup.prefill_fn(max_len=max_len)
        prompt_batch = {"tokens": prompts.to(dev)[rows]}
        if prefix_embed is not None:
            prompt_batch["prefix_embed"] = prefix_embed.to(dev)[rows]
        decode = setup.decode_fn()

        def sample(lg):
            if temperature <= 0:
                return lg.argmax(-1)[:, None]
            probs = torch.softmax(lg.float() / temperature, -1)
            return torch.multinomial(probs, 1, generator=gen)

        _sync(dev)
        with phase("prefill"):
            t0 = time.perf_counter()
            logits, cache = prefill(params, prompt_batch)
            first_logits = logits
            tok = sample(logits)
            _sync(dev)
            prefill_ms = (time.perf_counter() - t0) * 1e3
        out, lat, kept = [tok], [], []
        with phase("decode"):
            for i in range(N - 1):
                pos = torch.full((tok.shape[0],), P + S + i, dtype=torch.int32,
                                 device=dev)
                t1 = time.perf_counter()
                logits, cache = decode(params, cache,
                                       {"tokens": tok, "pos": pos})
                tok = sample(logits)
                _sync(dev)
                lat.append((time.perf_counter() - t1) * 1e3)
                out.append(tok)
                if keep_logits:
                    kept.append(logits.cpu())
                if sink is not None:
                    sink.stage_array("decode_ms", np.float32([lat[-1]]), step=i)
        tokens = torch.cat(out, dim=1)
        step_logits = torch.stack(kept, 1) if keep_logits else None
        if setup.tp is not None and setup.tp.dp is not None:
            # every DP rank's rows, in order, on each rank
            tokens, first_logits = (setup.tp.gather(t, setup.tp.dp, dim=0)
                                    for t in (tokens, first_logits))
            if keep_logits:
                step_logits = setup.tp.gather(step_logits, setup.tp.dp, dim=0)
    if lat:
        lat_ms = np.asarray(lat)
        log(f"[serve] prefill {prefill_ms:.1f} ms; decode p50 "
            f"{np.percentile(lat_ms, 50):.2f} ms/tok, p99 "
            f"{np.percentile(lat_ms, 99):.2f} ms/tok "
            f"({B * 1e3 / lat_ms.mean():.1f} tok/s aggregate)")
    log(f"[serve] sample (req 0): {tokens[0, :16].tolist()}")
    return {"tokens": tokens, "prefill_logits": first_logits,
            "step_logits": step_logits,
            "prefill_ms": prefill_ms, "decode_ms": lat, "params": params,
            "prompts": prompts,
            "launches": {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES},
            "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                            if dev.type == "cuda" else 0.0)}


def _pool_tenancy(args):
    """The pool's tenants and default quota, and the token the sink writes
    with, from ``--tenant NAME[:TOKEN]`` and ``--quota-mb`` (the
    reference's wiring)."""
    from repro_torch.gateway import Tenant
    quota = (args.quota_mb << 20) or None
    if not args.tenant:
        return (), quota, None
    name, _, token = args.tenant.partition(":")
    return (Tenant(name, token=token or None, quota_bytes=quota),), None, \
        token or name


def main(argv=None) -> dict:
    """Parse ``argv`` and serve; on a mesh of more than one rank, one process
    a rank. Returns ``serve``'s results (rank 0's)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM (one process a rank; tensor and "
                         "expert parallelism over M), single or multi")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises when absent")
    ap.add_argument("--intransit", action="store_true",
                    help="stage per-step latencies into SAVIME")
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
                         "pages stored once (needs --page-kb)")
    ap.add_argument("--codec", default="none",
                    help="egress reduction codec for staged datasets "
                         "(none | delta-rle | int8-block; DESIGN.md §13)")
    ap.add_argument("--decode-at", default="staging",
                    choices=["staging", "query"],
                    help="decode coded datasets at ingest (default) or "
                         "store them compressed and decode lazily on the "
                         "staging->SAVIME hop")
    ap.add_argument("--analyzer", default=None,
                    choices=analysis.analyzers.available(),
                    help="summarize staged decode latencies with a "
                         "registered analyzer (needs --intransit)")
    ap.add_argument("--pool", type=int, default=0,
                    help="run N staging backends behind one gateway "
                         "(DESIGN.md §12; 0 = single staging server)")
    ap.add_argument("--tenant", default=None, metavar="NAME[:TOKEN]",
                    help="gateway tenant to write as (needs --pool); "
                         "NAME:TOKEN registers the tenant with that token")
    ap.add_argument("--quota-mb", type=int, default=0,
                    help="per-tenant byte quota in MiB (needs --pool; "
                         "0 = unlimited)")
    ap.add_argument("--faults", default=None,
                    help="seeded fault plan for the staging path — a DSL "
                         "string ('seed=42;drop:op=stripe,prob=0.01;"
                         "kill:target=staging:0,at_s=0.5') or a JSON plan "
                         "file; exercises retry/replay (DESIGN.md §15)")
    args = ap.parse_args(argv)
    try:
        parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    mesh = None if args.mesh == "1x1" else args.mesh
    if args.analyzer and not args.intransit:
        ap.error("--analyzer requires --intransit")
    if (args.tenant or args.quota_mb) and not args.pool:
        ap.error("--tenant/--quota-mb require --pool")
    if args.pool and args.transport != "rdma_staged":
        ap.error("--pool requires the rdma_staged transport")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    run = functools.partial(serve, cfg, batch=args.batch,
                            prompt_len=args.prompt_len,
                            new_tokens=args.new_tokens,
                            temperature=args.temperature, device=args.device,
                            mesh=mesh)
    if not args.intransit:
        return run()

    from repro_torch.core import (InTransitConfig, InTransitSink,
                                  SavimeServer, StagingServer)
    staging_kw = {"page_bytes": args.page_kb << 10,
                  "spill_dir": args.spill_dir, "dedup": args.dedup}
    with contextlib.ExitStack() as stack:
        tenant_token = pool = savime = None
        if args.pool:
            from repro_torch.gateway import StagingPool
            tenants, default_quota, tenant_token = _pool_tenancy(args)
            pool = StagingPool(args.pool, tenants=tenants,
                               default_quota_bytes=default_quota,
                               staging_kwargs=staging_kw).start()
            stack.callback(pool.stop)
            sink_addr = pool.addr
            print(f"[serve] staging pool: {args.pool} backends behind "
                  f"gateway {pool.addr}")
            scope = [pool.addr] + [st.addr for st in pool.stagings] \
                + [sv.addr for sv in pool.savimes]
            targets = {"gateway": pool.gateway.stop}
            targets.update({f"staging:{i}": st.stop
                            for i, st in enumerate(pool.stagings)})
            targets.update({f"savime:{i}": sv.stop
                            for i, sv in enumerate(pool.savimes)})
        else:
            savime = SavimeServer().start()
            stack.callback(savime.stop)
            staging = StagingServer(savime.addr, **staging_kw).start()
            stack.callback(staging.stop)
            sink_addr = (staging.addr if args.transport == "rdma_staged"
                         else savime.addr)
            scope = [staging.addr, savime.addr]
            targets = {"staging:0": staging.stop, "savime:0": savime.stop}
        if args.faults:
            from repro_torch.faults import (FaultPlan, FaultScheduler,
                                            install, uninstall)
            plan = FaultPlan.parse(args.faults)
            install(plan, scope=scope)
            stack.callback(uninstall)
            stack.callback(FaultScheduler(plan, targets).start().stop)
            print(f"[serve] fault plan armed (seed={plan.seed}, "
                  f"{len(plan.rules)} rule(s))")
        make_sink = functools.partial(InTransitSink, sink_addr, InTransitConfig(
            tar_prefix="serve", transport=args.transport,
            n_channels=args.channels, wire_format=args.wire_format,
            coalesce_bytes=args.coalesce_kb << 10,
            page_bytes=args.page_kb << 10, spill_dir=args.spill_dir,
            dedup=args.dedup, gateway=bool(args.pool), tenant=tenant_token,
            codec=args.codec, decode_at=args.decode_at))
        # one device: the sink is this process's; on a mesh rank 0 makes
        # its own, stages, flushes and closes it
        sink = make_sink() if mesh is None else None
        try:
            out = (run(sink=sink) if sink is not None
                   else run(make_sink=make_sink))
            if sink is not None:
                sink.flush()
            if args.analyzer:
                if pool is not None:
                    from repro_torch.gateway import RouterSession
                    an_ctx = RouterSession(gateway_addr=pool.addr)
                else:
                    an_ctx = analysis.AnalysisSession(savime.addr)
                with an_ctx as an:
                    res = an.execute(
                        analysis.tar("serve_decode_ms").attr("v").select())
                    a = analysis.analyzers.create(args.analyzer)
                    a.update(res)
                    s = a.summary()
                    print(f"[serve] analyzer[{s.analyzer}] over "
                          f"{res.shape} staged latencies: {s.payload}")
        finally:
            if sink is not None:
                sink.close()
        gw = sink.session.stats.gateway if sink is not None else out["gateway"]
        if gw:
            print(f"[serve] gateway: {gw['totals']} across "
                  f"{gw['live_backends']}/{gw['n_backends']} backends; "
                  f"tenants: {gw['tenants']}")
    return out


if __name__ == "__main__":
    main()
