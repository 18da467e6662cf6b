"""Parameter machinery + shared layers, the port of ``repro/models/layers.py``.

Parameters are nested dicts of tensors. Each is declared once as a
``ParamSpec`` (shape, dtype, initializer); ``init_params`` materializes a
spec tree on one device from one ``torch.Generator``. Sharding annotations
have no counterpart on one device (the reference's ``constrain`` is a no-op
there), so specs carry no logical axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

Tree = Any


def to_dtype(dt) -> torch.dtype:
    """'float32' / 'bfloat16' / torch.dtype -> torch.dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    return getattr(torch, dt)


# ---------------------------------------------------------------------------
# ParamSpec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: Any = torch.float32
    init: str = "normal"   # normal | zeros | ones | neg_ones
    scale: float = 1.0     # fan-in style scale multiplier for "normal"

    def materialize(self, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        dt = to_dtype(self.dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        if self.init == "neg_ones":
            return torch.full(self.shape, -1, dtype=dt, device=device)
        if self.init != "normal":
            raise ValueError(f"unknown init {self.init!r}")
        # truncated normal at +-2 sigma, fan-in scaled. As in the reference,
        # the fan-in is the leading axis, which for a stacked spec is the
        # layers axis.
        fan_in = self.shape[0] if len(self.shape) >= 2 else max(self.shape[-1], 1)
        std = self.scale / math.sqrt(fan_in)
        arr = torch.empty(self.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(arr, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (arr * std).to(dt)


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """Apply fn to every leaf (spec or tensor) of a nested dict/list tree,
    visiting dict keys in sorted order (the reference's flatten order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t) for t in tree]
    return fn(tree)


def init_params(spec_tree: Tree, generator: torch.Generator,
                device: torch.device) -> Tree:
    return tree_map(lambda s: s.materialize(generator, device), spec_tree)


def stack_specs(spec_tree: Tree, n: int) -> Tree:
    """Prepend a stacked `layers` axis of length n to every spec."""
    return tree_map(lambda s: dataclasses.replace(s, shape=(n, *s.shape)),
                    spec_tree)


def unstack(tree: Tree, n: int) -> list:
    """A tree of (n, ...) tensors -> n trees of views, one per layer."""
    return [tree_map(lambda t, i=i: t[i], tree) for i in range(n)]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = (1.0 + scale.float()) if plus_one else scale.float()
    return (y * s).to(x.dtype)


def rms_norm_spec(dim: int, plus_one: bool = False) -> ParamSpec:
    return ParamSpec((dim,), init="zeros" if plus_one else "ones")


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


ACTS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
    "relu": F.relu,
}


# -- MLP --------------------------------------------------------------------


def mlp_specs(d_model: int, d_ff: int, glu: bool, pdt) -> dict[str, ParamSpec]:
    specs = {
        "wi": ParamSpec((d_model, d_ff), pdt),
        "wo": ParamSpec((d_ff, d_model), pdt),
    }
    if glu:
        specs["wg"] = ParamSpec((d_model, d_ff), pdt)
    return specs


def mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    a = ACTS[act](dense(x, params["wi"]))
    if "wg" in params:
        a = a * dense(x, params["wg"])
    return dense(a, params["wo"])


# -- RoPE -------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                  # (B,S,half)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# -- Embedding --------------------------------------------------------------


def embed_specs(vocab: int, d_model: int, tie: bool, pdt) -> dict[str, ParamSpec]:
    specs = {"table": ParamSpec((vocab, d_model), pdt, scale=1.0)}
    if not tie:
        specs["head"] = ParamSpec((d_model, vocab), pdt)
    return specs


def embed(params: dict, tokens: torch.Tensor, scale: bool,
          dtype: torch.dtype) -> torch.Tensor:
    x = params["table"].to(dtype)[tokens]
    if scale:
        # the scale is rounded to the compute dtype first, as the reference does
        x = x * torch.tensor(math.sqrt(params["table"].shape[1]), dtype=dtype,
                             device=x.device)
    return x


def unembed(params: dict, x: torch.Tensor, tie: bool) -> torch.Tensor:
    w = params["table"].T if tie else params["head"]
    return x @ w.to(x.dtype)
