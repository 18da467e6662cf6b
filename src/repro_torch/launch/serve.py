"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Prefill a batch of prompts, then decode greedily (or by sampling at a
temperature) with the KV cache updated in place. The port of
``repro/launch/serve.py`` without its in-transit data plane and mesh flags.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Any, Callable, ContextManager, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
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
          log: Callable[[str], None] = print,
          phase: Callable[[str], ContextManager[Any]] = _no_phase) -> dict:
    """Serve `batch` prompts of `prompt_len` tokens and generate `new_tokens`
    tokens each. Parameters and prompts are made from `seed` unless given.
    `phase(name)` is entered around the timed prefill ("prefill") and the
    decode loop ("decode"), e.g. to trace each with a profiler.

    Returns tokens (B, new_tokens), the prefill's last-token logits (B, V),
    prefill_ms, decode_ms (one per decode step), and the params and prompts
    used (params in the compute dtype)."""
    dev = resolve_device(device)
    model = Model(cfg)
    setup = ServeSetup(model)
    B, S, N = batch, prompt_len, new_tokens
    log(f"[serve] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
        f"{cfg.n_layers} layers on {dev}, batch {B} x prompt {S} + {N} new")
    with torch.inference_mode():
        if params is None:
            params = model.init(seed, dev)
        params = model.compute_params(params)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        if prompts is None:
            prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device=dev)
        prefill = setup.prefill_fn(max_len=S + N)
        decode = setup.decode_fn()

        def sample(lg):
            if temperature <= 0:
                return lg.argmax(-1)[:, None]
            probs = torch.softmax(lg.float() / temperature, -1)
            return torch.multinomial(probs, 1, generator=gen)

        _sync(dev)
        with phase("prefill"):
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"tokens": prompts})
            first_logits = logits
            tok = sample(logits)
            _sync(dev)
            prefill_ms = (time.perf_counter() - t0) * 1e3
        out, lat = [tok], []
        with phase("decode"):
            for i in range(N - 1):
                pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
                t1 = time.perf_counter()
                logits, cache = decode(params, cache,
                                       {"tokens": tok, "pos": pos})
                tok = sample(logits)
                _sync(dev)
                lat.append((time.perf_counter() - t1) * 1e3)
                out.append(tok)
        tokens = torch.cat(out, dim=1)
    if lat:
        lat_ms = np.asarray(lat)
        log(f"[serve] prefill {prefill_ms:.1f} ms; decode p50 "
            f"{np.percentile(lat_ms, 50):.2f} ms/tok, p99 "
            f"{np.percentile(lat_ms, 99):.2f} ms/tok "
            f"({B * 1e3 / lat_ms.mean():.1f} tok/s aggregate)")
    log(f"[serve] sample (req 0): {tokens[0, :16].tolist()}")
    return {"tokens": tokens, "prefill_logits": first_logits,
            "prefill_ms": prefill_ms, "decode_ms": lat, "params": params,
            "prompts": prompts}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises when absent")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
          new_tokens=args.new_tokens, temperature=args.temperature,
          device=args.device)


if __name__ == "__main__":
    main()
