"""The raw weights of a configuration, drawn from the seed on the device.

One ``torch.Generator`` on the device, seeded with the run's seed, draws
every weight in a fixed order: the model's own (embedding, final norm,
head), then each block kind's, each name as one stacked tensor over the
layers of that kind, in the dtype it is served in (matrices bfloat16,
vectors float32). So a configuration's weights are a few tens of large
calls, and the same seed gives the same bits.

These tensors are handed to the program (``chipbench.port``) and to the
reference alike; neither side changes them.
"""
from __future__ import annotations

import math

import torch

from chipbench.reference import model as ref_model


def seed64(seed: int) -> int:
    """Any whole number as a 64-bit seed."""
    return seed % (1 << 64)


def _draw(shape: tuple, dtype: str, init: tuple, gen: torch.Generator,
          device) -> torch.Tensor:
    dt = getattr(torch, dtype)
    kind = init[0]
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=device, dtype=dt).mul_(init[1])
    if kind == "jitter":          # 1 + s * N(0, 1): a norm scale near one
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dt).mul_(init[1]).add_(1.0)
    if kind == "ones":
        return torch.ones(shape, device=device, dtype=dt)
    if kind == "a_log":           # S4D-real: A = -(1..N) on every channel
        n = torch.arange(1, shape[-1] + 1, device=device, dtype=torch.float32)
        return torch.log(n).expand(shape).to(dt).contiguous()
    if kind == "dt_bias":         # softplus^-1 of dt log-uniform in [lo, hi]
        lo, hi = math.log(init[1]), math.log(init[2])
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        dt_ = torch.exp(u * (hi - lo) + lo)
        return (dt_ + torch.log(-torch.expm1(-dt_))).to(dt)
    raise ValueError(f"unknown init {init!r}")


def make(c: dict, seed: int, device) -> dict:
    """{"model": {name: tensor}, "layers": {kind: {name: (n_kind, ...)}}}."""
    gen = torch.Generator(device=device).manual_seed(seed64(seed))
    out = {"model": {}, "layers": {}}
    for name, (shape, dtype, init) in sorted(ref_model.model_weights(c).items()):
        out["model"][name] = _draw(shape, dtype, init, gen, device)
    kinds = ref_model.layer_kinds(c)
    for kind in sorted(set(kinds)):
        n = kinds.count(kind)
        table = ref_model.block(kind).weights(c)
        out["layers"][kind] = {
            name: _draw((n, *shape), dtype, init, gen, device)
            for name, (shape, dtype, init) in sorted(table.items())}
    return out

