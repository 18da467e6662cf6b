"""Batched serving example, the port's twin of ``examples/serve_batched.py``:
prefill a batch of prompts, decode tokens against a KV cache updated in
place, greedy sampling, on the qwen2-72b smoke config (dense GQA with QKV
biases). Runs on the GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.train import ServeSetup

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default) or cpu; cuda raises when absent")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = get_config("qwen2-72b").smoke()
model = Model(cfg)
setup = ServeSetup(model)

B, S, N_NEW = 4, 48, 16
with torch.inference_mode():
    params = model.compute_params(model.init(seed=0, device=dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev)

    prefill = setup.prefill_fn(max_len=S + N_NEW)
    decode = setup.decode_fn()

    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    tok = logits.argmax(-1)[:, None]
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i in range(N_NEW - 1):
        pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
        logits, cache = decode(params, cache, {"tokens": tok, "pos": pos})
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_decode = time.perf_counter() - t0

gen_tokens = torch.cat(out, dim=1)
print(f"prefill {B}x{S} in {t_prefill * 1e3:.0f} ms; "
      f"{N_NEW - 1} decode steps in {t_decode * 1e3:.0f} ms "
      f"({t_decode / (N_NEW - 1) * 1e3:.1f} ms/tok incl. dispatch) on {dev}")
print("generated token ids (batch 0):", gen_tokens[0].tolist())
assert gen_tokens.shape == (B, N_NEW)
assert bool((gen_tokens >= 0).all()) and bool((gen_tokens < cfg.vocab_size).all())
print("OK")
