"""Parameter machinery + shared layers, the port of ``repro/models/layers.py``.

Parameters are nested dicts of tensors. Each is declared once as a
``ParamSpec`` (shape, dtype, initializer); ``init_params`` materializes a
spec tree on one device from one ``torch.Generator``, whole or as one
rank's shard. Specs carry the reference's logical axes, which the sharding
rules map onto a mesh (``train.sharding``) and ZeRO-1 reads to pick the
dimension it splits.

On a mesh with ``model`` > 1 the layers take a ``tp`` context
(``train.sharding.TPContext``) and hold their shards: a column-parallel
``dense`` takes its input through ``tp.to_model`` (the input's gradient is
summed over ``model``; each caller does this once for the products that
share an input); ``row_dense`` sums its partial over ``model`` in f32 and
rounds once (``tp.reduce``), as GSPMD all-reduces the dot's f32 accumulator
(the reference's default, ``_LOWP_COLLECTIVES = False``). Under
``lowp_collectives()`` the partial is the product in the compute dtype and
the sum rides the wire in it, as the reference's ``lowp`` option emits the
contraction's output in the compute dtype. Without ``tp`` every layer is
the one-device one, bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Optional

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
    init: str = "normal"   # normal | zeros | ones | neg_ones | a_log
    scale: float = 1.0     # fan-in style scale multiplier for "normal"
    keep_dtype: bool = False   # Model.compute_params leaves it in `dtype`
    # the reference's logical axes, one name (or None) a dim; () for a
    # cache spec. The port reads them for ZeRO-1's split (optim.zero1_plan)
    axes: tuple = ()
    # the sharded axis holds this many equal blocks side by side, each cut
    # alike (mamba's in_proj: [x | z])
    parts: int = 1

    def materialize(self, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        dt = to_dtype(self.dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        if self.init == "neg_ones":
            return torch.full(self.shape, -1, dtype=dt, device=device)
        if self.init == "a_log":  # mamba A init: log(1..d_state) per channel
            a = torch.arange(1, self.shape[-1] + 1, dtype=torch.float32,
                             device=device)
            return torch.log(a).expand(self.shape).to(dt).contiguous()
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
        return arr.mul_(std).to(dt)   # in place: no second f32 copy


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """Apply fn to every leaf (spec or tensor) of a nested dict/list tree,
    visiting dict keys in sorted order (the reference's flatten order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t) for t in tree]
    return fn(tree)


def tree_leaves(tree: Tree) -> list:
    """The leaves of a nested dict/list tree in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def abstract_params(spec_tree: Tree) -> Tree:
    """Every leaf as a meta tensor of its spec's shape and dtype: no
    storage, no generator (the reference's ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=to_dtype(s.dtype),
                                          device="meta"), spec_tree)


def init_params(spec_tree: Tree, generator: torch.Generator,
                device: torch.device, cut: Optional[Callable] = None) -> Tree:
    """Every leaf drawn whole, in order, from ``generator``. With ``cut``
    (spec -> that leaf's share, ``train.sharding.local_slice``) each leaf
    keeps only its share, copied out before the next is drawn: a rank's
    bits are the one-device init's."""
    if cut is None:
        return tree_map(lambda s: s.materialize(generator, device), spec_tree)
    from repro_torch.train.sharding import is_whole, take

    def one(s):
        cuts = cut(s)
        whole = s.materialize(generator, device)
        return whole if is_whole(cuts, s.shape) else take(whole, cuts).clone()

    return tree_map(one, spec_tree)


def stack_specs(spec_tree: Tree, n: int) -> Tree:
    """Prepend a stacked `layers` axis of length n to every spec."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(n, *s.shape), axes=("layers", *s.axes) if s.axes else ()),
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
    return ParamSpec((dim,), init="zeros" if plus_one else "ones",
                     axes=("embed",))


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


_LOWP = [False]   # set by lowp_collectives(); read where a partial is made


@contextlib.contextmanager
def lowp_collectives(enabled: bool = True):
    """Within the block the row-parallel partials are taken in the compute
    dtype and summed over ``model`` in it (bf16 on the wire instead of the
    f32 accumulator: half the bytes), the reference's ``lowp`` option."""
    prev = _LOWP[0]
    _LOWP[0] = enabled
    try:
        yield
    finally:
        _LOWP[0] = prev


def lowp() -> bool:
    return _LOWP[0]


def row_dense(x: torch.Tensor, w: torch.Tensor, tp=None,
              sublayer_out: bool = True) -> torch.Tensor:
    """``dense`` with ``w``'s rows (the contraction) sharded over ``model``:
    each rank's f32 partial, summed over the ranks and rounded once (under
    ``lowp_collectives`` the partial in ``x``'s dtype, summed in it).
    ``sublayer_out``: the sum is a sublayer's output, which the "comm"
    remat policy keeps (``TPContext.reduce``)."""
    if tp is None or tp.m == 1:
        return dense(x, w)
    if lowp():
        return tp.reduce(dense(x, w), x.dtype, sublayer_out, wide=False)
    return tp.reduce(x.float() @ w.float(), x.dtype, sublayer_out=sublayer_out)


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
        "wi": ParamSpec((d_model, d_ff), pdt, axes=("embed", "ffn")),
        "wo": ParamSpec((d_ff, d_model), pdt, axes=("ffn", "embed")),
    }
    if glu:
        specs["wg"] = ParamSpec((d_model, d_ff), pdt, axes=("embed", "ffn"))
    return specs


def mlp(params: dict, x: torch.Tensor, act: str, tp=None) -> torch.Tensor:
    """``wi``/``wg`` column-parallel, ``wo`` row-parallel under ``tp``."""
    if tp is not None:
        x = tp.to_model(x)
    a = ACTS[act](dense(x, params["wi"]))
    if "wg" in params:
        a = a * dense(x, params["wg"])
    return row_dense(a, params["wo"], tp)


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
    specs = {"table": ParamSpec((vocab, d_model), pdt, scale=1.0,
                                 axes=("vocab", "embed"))}
    if not tie:
        specs["head"] = ParamSpec((d_model, vocab), pdt, axes=("embed", "vocab"))
    return specs


def embed(params: dict, tokens: torch.Tensor, scale: bool,
          dtype: torch.dtype, tp=None) -> torch.Tensor:
    """Under ``tp`` the table's rows (the vocab) are sharded: each rank
    looks up the tokens in its range, zero elsewhere, and the sum over
    ``model`` (one nonzero term a token, so exact) is the lookup.

    The rows are gathered from the table and then cast, which gives the
    bits of a gather from the cast table; its gradient is then added into
    the table's rows in the table's dtype. (Gathered from a bf16 copy, the
    gradient of a token that recurs is summed in bf16, one rounding a
    recurrence: the CUDA kernel stores the row after each. Over 2 x 4096
    Zipf tokens that lost 8% of gemma3-4b's table gradient norm.)"""
    table = params["table"]
    if tp is None or tp.m == 1:
        x = table[tokens].to(dtype)
    else:
        lo = tp.r * table.shape[0]              # this rank's vocab rows
        mine = (tokens >= lo) & (tokens < lo + table.shape[0])
        local = torch.where(mine, tokens - lo, 0)
        x = torch.where(mine[..., None], table[local].to(dtype), 0)
        x = tp.reduce(x, dtype)
    if scale:
        # the scale is rounded to the compute dtype first, as the reference does
        x = x * torch.tensor(math.sqrt(table.shape[1]), dtype=dtype,
                             device=x.device)
    return x


def unembed(params: dict, x: torch.Tensor, tie: bool, tp=None,
            gather: bool = True) -> torch.Tensor:
    """Under ``tp`` the vocab is sharded: each rank's logits, gathered over
    ``model`` in vocab order, or with ``gather`` False this rank's columns
    alone (the vocab-parallel cross-entropy's)."""
    w = params["table"].T if tie else params["head"]
    if tp is not None:
        x = tp.to_model(x)
    lg = x @ w.to(x.dtype)
    return lg if tp is None or not gather else tp.gather(lg)
