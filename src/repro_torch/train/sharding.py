"""Logical-axis -> mesh-axis sharding rules, the port of
``repro/train/sharding.py``.

DP over (pod, data); TP/EP over model; SP (the sequence-sharded KV cache)
over data for long-context decode. ``make_rules`` is the reference's, rule
for rule. Where the reference hands the rules to GSPMD, the port turns them
into each rank's share: ``local_slice`` cuts one spec, ``shard_tree`` a
whole tree and ``unshard`` puts a leaf back together from its shares, and
``TPContext`` carries the mesh, the rules and the head plan into the model,
whose layers meet over ``model`` (and, in SP decode, over ``data``) only
where GSPMD would insert a collective. ``batch`` picks the rows of the
global batch a rank takes (``shard_batch``), and ZeRO-1 splits the moments
over DP (``optim.optimizer.zero1_plan``).

Training differentiates the sharded program by hand, where GSPMD
differentiates it for the reference: each collective of ``TPContext`` is an
``autograd.Function`` with its own backward, Megatron's pair around the
model all-reduce (``to_model``: identity forward, all-reduce backward, on
the input of the column-parallel products; ``reduce``: all-reduce forward,
identity backward, on the row-parallel sums), a gather whose backward takes
this rank's slice, the vocab-parallel log-partition of the cross-entropy,
and for ``fsdp_experts`` an all-gather over ``data`` whose backward sums the
gradients over ``data`` and keeps this rank's slice.

An axis is cut by what it means where that differs from a contiguous cut of
the stored axis: the flat ``qkv`` projections on whole query heads and a KV
cache's flat axis on their KV heads (``head_plan``), and an axis that holds
``ParamSpec.parts`` equal blocks side by side (mamba's ``in_proj``, [x | z])
block by block. Every other axis, the flat KV projections too, is cut
evenly, as GSPMD cuts the reference's: so a rank's params have the
reference's shard shapes on every mesh. Where a rank's heads read KV
columns that other ranks store (MQA, or a model axis the KV heads do not
divide), the layer gathers them; where ``model`` divides neither the query
heads nor ``pad_heads_to`` (gemma3-4b's 8 over 16), the query projection
is cut mid-head and every rank gathers all of q, k and v and computes every
head, keeping its own columns of the output for the row-parallel ``wo``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import dp_axes  # noqa: F401  (re-exported)
from repro_torch.models.layers import tree_map


def make_rules(mesh, cfg=None, *, seq_shard_kv: bool = False,
               global_batch: int = 0) -> dict[str, Any]:
    model_n = mesh.shape.get("model", 1)
    dp = dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= mesh.shape[a]
    if global_batch and global_batch % dp_total:
        dp_rule: Any = None   # batch=1 long-context decode: replicate batch,
                              # parallelism comes from SP (kv_seq) + model
    else:
        dp_rule = dp if len(dp) > 1 else (dp[0] if dp else None)

    def maybe_model(size: Optional[int], min_per_shard: int = 1):
        """Shard over model only when evenly divisible; else replicate."""
        if size is None or (size % model_n == 0
                            and size >= model_n * min_per_shard):
            return "model"
        return None

    kv = cfg.n_kv_heads if cfg is not None else None
    return {
        "batch": dp_rule,
        "vocab": "model",
        "embed": None,
        # attention projections are stored flattened (H*D divisible by 16
        # for every assigned arch) -> TP always shards them
        "qkv": "model",
        "kv_flat": "model",
        # per-head axes appear only on caches/activations: shard when a
        # whole head fits per shard (MQA caches replicate — tiny anyway)
        "heads": maybe_model(cfg.n_heads if cfg is not None else None),
        "heads_padded": maybe_model(
            max(cfg.pad_heads_to, cfg.n_heads) if cfg is not None else None),
        "kv_heads": maybe_model(kv),
        "head_dim": None,
        "ffn": "model",
        "expert": "model",
        "expert_ffn": None,
        "capacity": None,
        "inner": "model",
        "rnn": "model",
        "state": None,
        "conv": None,
        "dt": None,
        "layers": None,
        # decode-time KV cache sequence axis: sharded over `data` for
        # long-context (SP decode; batch=1 cannot use DP), else replicated
        "kv_seq": "data" if seq_shard_kv else None,
    }


def batch_rows(mesh, rules, n_rows: int, microbatches: int = 1):
    """The rows of an ``n_rows`` global batch this rank takes: the whole
    batch where ``rules["batch"]`` replicates it, else its DP position's
    contiguous block (pod-major over the DP axes, as the reference's
    ``P(("pod", "data"))`` places them), a slice. With ``microbatches`` n
    the reference splits the global batch into n contiguous microbatches
    and puts DP on each: the rows are then this rank's block of each
    microbatch in turn (a list of indices), so that the step's contiguous
    split of them gives microbatch i its DP share of global microbatch i."""
    dp = rules["batch"]
    if dp is None:
        return slice(0, n_rows)
    n, index = _axis_share(mesh, dp)
    if n_rows % (n * microbatches):
        raise ValueError(f"a batch of {n_rows} rows does not split over {n} "
                         f"DP ranks ({dp}) in {microbatches} microbatches")
    if n == 1 or microbatches == 1:
        per = n_rows // n
        return slice(index * per, (index + 1) * per)
    mb, per = n_rows // microbatches, n_rows // (n * microbatches)
    return [i * mb + index * per + r for i in range(microbatches)
            for r in range(per)]


def shard_batch(mesh, rules, batch: dict, microbatches: int = 1) -> dict:
    """This rank's rows of every array of the global ``batch`` (numpy or
    tensors, leading axis the batch; ``batch_rows`` with the step's
    ``microbatches``). Replaces the reference's ``batch_shardings``: a rank
    holds its shard and nothing else."""
    rows = batch_rows(mesh, rules, next(iter(batch.values())).shape[0],
                      microbatches)
    return {k: (np.ascontiguousarray(v[rows]) if isinstance(v, np.ndarray)
                else v[rows].contiguous()) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Each rank's share of a spec
# ---------------------------------------------------------------------------


def head_plan(cfg, model_n: int, model_index: int
              ) -> Optional[tuple[int, int, int, int]]:
    """(h_lo, h_hi, kv_lo, kv_hi): the query heads this model rank computes,
    a contiguous range of the real heads, and the KV heads they read (head h
    reads h // G), which are its own where ``model`` divides the KV heads
    and shared with its neighbours where it does not (MQA).

    With ``pad_heads_to`` above n_heads the reference pads each KV group of
    G query heads to Gp = pad_heads_to // Hkv (the pad heads inert) and
    shards the padded heads: where ``model`` divides them, a rank owns a
    range of the padded heads, computes the real ones among it and skips
    the pad. Otherwise the real heads split evenly. Where ``model`` divides
    neither, the heads split mid-head, as GSPMD cuts the flat projections
    of the reference (gemma3-4b's 8 heads over 16 ranks): None, and every
    rank computes every head (``TPContext.split``); where ``model`` does
    not divide the flat projections either, this raises."""
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    G, pad = Hq // Hkv, cfg.pad_heads_to
    if pad > Hq and pad % model_n == 0:
        Gp, per = pad // Hkv, pad // model_n

        def real_before(p):          # the real heads among padded 0..p-1
            return (p // Gp) * G + min(p % Gp, G)
        h_lo = real_before(model_index * per)
        h_hi = real_before((model_index + 1) * per)
    elif Hq % model_n == 0:
        per = Hq // model_n
        h_lo, h_hi = model_index * per, (model_index + 1) * per
    elif (Hq * cfg.head_dim) % model_n == 0 and (Hkv * cfg.head_dim) % model_n == 0:
        return None
    else:
        raise ValueError(f"model axis {model_n} divides neither n_heads {Hq} "
                         f"nor pad_heads_to {pad} of {cfg.name}, nor its "
                         f"flat projections")
    if h_hi == h_lo:
        return h_lo, h_hi, h_lo // G, h_lo // G
    return h_lo, h_hi, h_lo // G, (h_hi - 1) // G + 1


def _axis_share(mesh, rule) -> tuple[int, int]:
    """(n, index): how many ranks share a dimension that ``rule`` maps onto
    mesh axes, and this rank's position among them (mixed radix, the first
    axis major, as the reference lays out a tuple of mesh axes)."""
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    n, index = 1, 0
    for a in axes:
        n, index = n * mesh.shape[a], index * mesh.shape[a] + mesh.coords[a]
    return n, index


Cuts = tuple  # one list of (start, stop) ranges a dimension


def _rule(rules: dict, axis: Optional[str]):
    """The mesh axes a logical axis maps onto. A KV cache's flat axis
    (``kv_cache``, the reference's ``kv_flat``) follows ``kv_flat``'s rule
    and is cut on the rank's KV heads."""
    if not axis:
        return None
    return rules.get("kv_flat" if axis == "kv_cache" else axis)


def local_slice(spec, mesh, rules: dict, cfg=None) -> Cuts:
    """This rank's share of ``spec`` (its shape and logical ``axes``): for
    each dimension, the ranges of the stored axis it keeps, concatenated in
    order. ``qkv`` is cut on the query heads of ``head_plan`` and a KV
    cache's ``kv_cache`` on their KV heads (``cfg`` gives the heads; every
    head, whole, where the plan splits mid-head); an axis of
    ``spec.parts`` blocks keeps its share of each block; every other axis
    that a rule maps onto the mesh (``kv_flat`` too: the reference's even
    cut, which the layer gathers where a rank's heads read other columns,
    ``TPContext.kv_cols``) splits evenly and raises where it does not
    divide."""
    cuts, used = [], set()
    axes = spec.axes or (None,) * len(spec.shape)
    for dim, (a, n) in enumerate(zip(axes, spec.shape)):
        rule = _rule(rules, a)
        if rule is None:
            cuts.append([(0, n)])
            continue
        mesh_axes = (rule,) if isinstance(rule, str) else tuple(rule)
        if used & set(mesh_axes):
            raise ValueError(f"spec {spec.shape} {axes}: two dimensions over "
                             f"mesh axis {sorted(used & set(mesh_axes))}")
        used |= set(mesh_axes)
        k, index = _axis_share(mesh, rule)
        plan = (head_plan(cfg, k, index)
                if a in ("qkv", "kv_cache") and rule == "model" else None)
        if plan is not None:
            h_lo, h_hi, kv_lo, kv_hi = plan
            lo, hi = (h_lo, h_hi) if a == "qkv" else (kv_lo, kv_hi)
            cuts.append([(lo * cfg.head_dim, hi * cfg.head_dim)])
            continue
        if a == "kv_cache" and rule == "model":     # every head, whole
            cuts.append([(0, n)])
            continue
        parts = spec.parts if rule == "model" else 1
        if n % (k * parts):
            raise ValueError(f"spec {spec.shape} {axes}: dimension {dim} "
                             f"({a}, {n}) does not split over {k} ranks of "
                             f"{mesh_axes}" + (f" in {parts} parts" if parts > 1 else ""))
        block = n // parts
        per = block // k
        cuts.append([(p * block + index * per, p * block + (index + 1) * per)
                     for p in range(parts)])
    return tuple(cuts)


def is_whole(cuts: Cuts, shape: tuple) -> bool:
    return all(c == [(0, n)] for c, n in zip(cuts, shape))


def cut_shape(cuts: Cuts) -> tuple[int, ...]:
    return tuple(sum(b - a for a, b in c) for c in cuts)


def take(x, cuts: Cuts):
    """``x`` (a tensor or a numpy array) cut to ``cuts``: a view where each
    dimension keeps one range, else a copy."""
    for dim, ranges in enumerate(cuts):
        if ranges == [(0, x.shape[dim])]:
            continue
        if isinstance(x, np.ndarray):
            pieces = [np.take(x, range(a, b), axis=dim) for a, b in ranges]
            x = pieces[0] if len(pieces) == 1 else np.concatenate(pieces, dim)
        else:
            pieces = [x.narrow(dim, a, b - a) for a, b in ranges]
            x = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)
    return x


def local_specs(spec_tree, mesh, rules: dict, cfg=None):
    """``spec_tree`` with every spec's shape cut to this rank's share."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=cut_shape(local_slice(s, mesh, rules, cfg))), spec_tree)


def shard_tree(tree, spec_tree, mesh, rules: dict, cfg=None):
    """This rank's shard of a whole ``tree`` (numpy arrays or tensors, in
    ``spec_tree``'s layout: the reference's, with stacked ``scan`` entries).
    A cut leaf is a copy of its share, so the whole can be freed."""
    def cut(spec, x):
        cuts = local_slice(spec, mesh, rules, cfg)
        if is_whole(cuts, spec.shape):
            return x
        part = take(x, cuts)
        return part.copy() if isinstance(part, np.ndarray) else part.clone()

    def walk(spec, x):
        if isinstance(x, dict):
            return {k: walk(spec[k], x[k]) for k in x}
        if isinstance(x, list):       # a scan entry's periods, in the port's layout
            return [walk(s, xx) for s, xx in zip(spec, x)]
        return cut(spec, x)

    return walk(spec_tree, tree)


def _at(mesh, axis: str, index: int):
    """What ``local_slice`` reads of the mesh, at another coordinate on
    ``axis``."""
    return types.SimpleNamespace(shape=mesh.shape,
                                 coords={**mesh.coords, axis: index})


def mesh_axes(spec, rules: dict) -> dict[str, int]:
    """{mesh axis: the dimension of ``spec`` it cuts}."""
    out = {}
    for dim, a in enumerate(spec.axes or ()):
        rule = _rule(rules, a)
        for m in ((rule,) if isinstance(rule, str) else tuple(rule or ())):
            out[m] = dim
    return out


def peer_cuts(spec, mesh, rules: dict, cfg, axis: str) -> list:
    """The cuts of ``spec`` of every rank along ``axis`` that shares this
    rank's other coordinates, in axis order."""
    return [local_slice(spec, _at(mesh, axis, i), rules, cfg)
            for i in range(mesh.shape[axis])]


def _place(out: torch.Tensor, part: torch.Tensor, ranges: list, dim: int) -> None:
    off = 0
    for a, b in ranges:
        out.narrow(dim, a, b - a).copy_(part.narrow(dim, off, b - a))
        off += b - a


def unshard(t: torch.Tensor, spec, mesh, rules: dict, cfg=None,
            axes: Optional[tuple] = None, dst: Optional[int] = None):
    """The leaf ``spec`` whole again from every rank's share ``t``, one mesh
    axis after the other (those of ``axes``, default every axis that cuts
    it): each rank's share placed by its cuts (``local_slice``), KV columns
    that ranks share written by each with the same bits. Collective over
    each axis's group; with ``dst`` the whole reaches the group's ``dst``-th
    rank alone and every other rank gets None (and takes part in no later
    axis: the next group's ranks all sit at ``dst`` of this one)."""
    for axis, dim in mesh_axes(spec, rules).items():
        group = mesh.groups[axis]
        if (axes is not None and axis not in axes) or group.size == 1:
            continue
        cuts = [c[dim] for c in peer_cuts(spec, mesh, rules, cfg, axis)]
        widths = [sum(b - a for a, b in c) for c in cuts]
        wide = max(widths)      # shares of unequal width (shared or padded
        if t.shape[dim] < wide:  # heads) travel padded to the widest
            pad = list(t.shape)
            pad[dim] = wide - t.shape[dim]
            t = torch.cat([t, t.new_zeros(pad)], dim)
        parts = (group.all_gather(t.contiguous()) if dst is None
                 else group.gather(t.contiguous(), dst))
        if parts is None:
            return None
        shape = list(t.shape)
        shape[dim] = spec.shape[dim]
        out = t.new_zeros(shape)
        for part, c, w in zip(parts, cuts, widths):
            _place(out, part.narrow(dim, 0, w), c, dim)
        t = out
    return t


def counted_cuts(spec, mesh, rules: dict, cfg=None) -> Optional[Cuts]:
    """The part of this rank's share of ``spec`` that it alone counts among
    the ranks of its ``model`` group (a sum over the group of what each
    counts covers each element once): None for the whole share, else local
    cuts, possibly empty. A leaf that ``model`` does not cut is counted by
    model rank 0; KV columns that ranks share by the first of them."""
    dim = mesh_axes(spec, rules).get("model")
    r = mesh.coords.get("model", 0)
    if dim is None or mesh.shape.get("model", 1) == 1:
        return None if r == 0 else tuple([] for _ in spec.shape)
    cuts = [c[dim] for c in peer_cuts(spec, mesh, rules, cfg, "model")]
    taken = set()
    for c in cuts[:r]:
        for a, b in c:
            taken.update(range(a, b))
    keep, off = [], 0
    for a, b in cuts[r]:
        for i in range(a, b):
            if i not in taken:
                if keep and keep[-1][1] == off:
                    keep[-1] = (keep[-1][0], off + 1)
                else:
                    keep.append((off, off + 1))
            off += 1
    if keep == [(0, off)]:
        return None
    mine = local_slice(spec, mesh, rules, cfg)
    return tuple(keep if d == dim else [(0, cut_shape((c,))[0])]
                 for d, c in enumerate(mine))


def shared_over_model(spec, mesh, rules: dict, cfg=None) -> bool:
    """Whether the ranks of a ``model`` group each hold a partial gradient
    of this leaf, to be summed over the group: the q/k norm scales
    (replicated, used on each rank's heads). A KV projection whose heads
    ranks share is stored cut evenly and gathered where it is used, its
    gradient summed by the gather's backward (``TPContext.attn_weights``)."""
    if mesh.shape.get("model", 1) == 1:
        return False
    return "head_dim" in (spec.axes or ())


# ---------------------------------------------------------------------------
# The model's view of the mesh
# ---------------------------------------------------------------------------


class TPContext:
    """What the layers need of the mesh: the ``model`` group (TP and EP),
    this rank's heads (``head_plan``), the ``data`` group where the global
    KV caches are sequence-sharded (``seq``, else None), the DP group where
    the batch rows are split (``dp``, else None), which MoE decode routes
    over as one group, as the reference's global batch is, and the ``data``
    group the expert weights are sharded over with ``fsdp_experts``
    (``fsdp``, else None: the rules map ``expert_ffn`` onto ``data``).

    Partial sums travel in f32 and are rounded once to the compute dtype
    (in the compute dtype under ``models.layers.lowp_collectives``, whose
    ``row_dense`` hands over a compute-dtype partial); gathers travel in
    f32 and come back in the tensor's dtype. Under autograd every
    collective has its backward (module docstring), and every rank issues
    the same collectives in the same order, forward, backward and the
    recompute of a checkpointed block alike.

    ``keeping(store)`` is the "comm" remat policy's hook: within it each
    sum marked ``sublayer_out`` (a block's attention, MLP, MoE or mixer
    output) is kept in ``store`` on the block's first pass, and on its
    recompute the kept sum is handed back, the partial's gradient passing
    as before, so the backward issues no forward all-reduce again."""

    def __init__(self, mesh, rules: dict, cfg):
        self.mesh, self.rules, self.cfg = mesh, rules, cfg
        self.model = mesh.groups["model"]
        self.m, self.r = self.model.size, self.model.index
        attn = any(k in ("dense", "local", "global", "moe")
                   for k in cfg.layer_pattern)
        plan = head_plan(cfg, self.m, self.r) if attn else None
        # split: the heads are cut mid-head; every rank computes them all
        self.split = plan is None and self.m > 1
        self.heads = plan or (0, cfg.n_heads, 0, cfg.n_kv_heads)
        h_lo, h_hi, kv_lo, kv_hi = self.heads
        D, per = cfg.head_dim, cfg.n_kv_heads * cfg.head_dim // self.m
        # the KV columns this rank's heads read, where it stores others
        self.kv_cols = (None if (kv_lo * D, kv_hi * D) ==
                        (self.r * per, (self.r + 1) * per)
                        else (kv_lo * D, kv_hi * D))
        n_q, n_kv = h_hi - h_lo, kv_hi - kv_lo
        G = cfg.n_heads // cfg.n_kv_heads
        kv_of = [h // G - kv_lo for h in range(h_lo, h_hi)]
        uniform = n_kv and n_q % n_kv == 0 and all(
            kv_of[i] == i // (n_q // n_kv) for i in range(n_q))
        # the KV head each local query head reads, where the grouping is
        # not G' consecutive heads a KV head (None where it is)
        self.kv_index = None if (uniform or not n_q) else kv_of
        seq = rules.get("kv_seq")
        self.seq = (mesh.groups[seq] if seq and mesh.groups[seq].size > 1
                    else None)
        self.dp = (mesh.dp if rules.get("batch") is not None and mesh.dp.size > 1
                   else None)
        ffn = rules.get("expert_ffn")
        self.fsdp = (mesh.groups[ffn] if ffn and mesh.groups[ffn].size > 1
                     else None)
        self.kept: Optional[KeptSums] = None

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        """The input of column-parallel products: itself; under autograd its
        gradient is summed over ``model``."""
        if self.m == 1 or not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _ToModel.apply(x, self.model)

    def reduce(self, partial: torch.Tensor, dtype: torch.dtype,
               sublayer_out: bool = False, wide: bool = True) -> torch.Tensor:
        """The sum over ``model`` of a partial, taken in f32 (with
        ``wide``; else in the partial's own dtype, as ``row_dense`` asks
        under ``lowp_collectives``) and rounded once to dtype; under
        autograd each rank's partial takes the sum's gradient.
        ``sublayer_out``: a block's sublayer output, kept under
        ``keeping``."""
        if self.m == 1:
            return partial.to(dtype)
        kept = self.kept if sublayer_out else None
        if kept is not None and kept.replaying:
            return _Replayed.apply(partial, kept.next())
        out = _Reduce.apply(partial, self.model, dtype, wide)
        if kept is not None:
            kept.sums.append(out.detach())
        return out

    @contextlib.contextmanager
    def keeping(self, store: "KeptSums"):
        """One pass of a block under the "comm" policy (class docstring)."""
        prev, self.kept = self.kept, store
        store.begin()
        try:
            yield
        finally:
            self.kept = prev

    def gather(self, t: torch.Tensor, group=None, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` of ``group`` (default ``model``) concatenated
        along ``dim``, in group order; under autograd each rank's ``t``
        takes its slice of the gradient."""
        group = group or self.model
        if group.size == 1:
            return t
        return _Gather.apply(t, group, dim)

    def attn_weights(self, params: dict) -> dict:
        """The attention projections this rank computes with: its own
        shares where they are what its heads read; else gathered over
        ``model`` (a gather whose backward sums the gradient over the group
        and keeps this rank's share): every q column where the heads are
        split mid-head, and the KV columns of its heads where ranks share
        them."""
        out = dict(params)
        if self.split:
            for w, dim in (("wq", 1), ("bq", 0)):
                if w in params:
                    out[w] = _GatherSum.apply(params[w], self.model, dim)
        if self.kv_cols is not None:
            lo, hi = self.kv_cols
            for w, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
                if w in params:
                    out[w] = _GatherSum.apply(params[w], self.model,
                                              dim).narrow(dim, lo, hi - lo)
        return out

    def own_columns(self, o: torch.Tensor) -> torch.Tensor:
        """Where the heads are split mid-head: this rank's even share of the
        flat attention output's columns, the rows its ``wo`` holds."""
        if not self.split:
            return o
        per = o.shape[-1] // self.m
        return o.narrow(-1, self.r * per, per)

    def fsdp_gather(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """An expert weight whole along ``dim`` (``expert_ffn``) from its
        shares over ``data`` with ``fsdp_experts``; its gradient summed over
        ``data`` and cut back to this rank's share (a reduce-scatter)."""
        if self.fsdp is None:
            return w
        return _GatherSum.apply(w, self.fsdp, dim)

    def logsumexp(self, lg: torch.Tensor) -> torch.Tensor:
        """log sum exp over the vocab of f32 logits whose last axis is this
        rank's vocab shard: the max and the sum of exponentials over
        ``model``; under autograd the gradient of each rank's logits is its
        columns of the softmax."""
        if self.m == 1:
            return torch.logsumexp(lg, dim=-1)
        return _VocabLogZ.apply(lg, self.model)


class KeptSums:
    """The sublayer sums of one block's forward, handed back in order on
    each later pass (its recomputes)."""

    def __init__(self):
        self.sums: list[torch.Tensor] = []
        self.passes = self.cursor = 0

    @property
    def replaying(self) -> bool:
        return self.passes > 1

    def begin(self) -> None:
        self.passes += 1
        self.cursor = 0

    def next(self) -> torch.Tensor:
        self.cursor += 1
        return self.sums[self.cursor - 1]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or as it is where it is wider (f64, integers)."""
    return t if t.dtype in (torch.float64, torch.int32, torch.int64) else t.float()


def _sum_f32(group, t: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``t``'s sum over ``group``, taken in f32 (or wider) and
    rounded once to ``t``'s dtype."""
    det = t.detach()
    buf = _wide(det)
    if buf is det:             # no copy made: ``t`` itself must not change
        buf = buf.clone()
    return group.all_reduce_sum(buf.contiguous()).to(t.dtype)


def _gather_f32(group, t: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cat(group.all_gather(_wide(t).contiguous()), dim=dim).to(t.dtype)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(ctx.group, g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, group, dtype, wide=True):
        ctx.in_dtype = partial.dtype
        det = partial.detach()
        buf = _wide(det) if wide else det
        if ctx.needs_input_grad[0] and buf is det:
            buf = buf.clone()      # a partial autograd may still read
        return group.all_reduce_sum(buf.contiguous()).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.in_dtype), None, None, None


class _Replayed(torch.autograd.Function):
    """A kept sum in place of its all-reduce: the partial's gradient is the
    sum's, as ``_Reduce``'s."""

    @staticmethod
    def forward(ctx, partial, kept):
        ctx.in_dtype = partial.dtype
        return kept.view_as(kept)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.in_dtype), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.dim, ctx.index, ctx.size = dim, group.index, t.shape[dim]
        return _gather_f32(group, t, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, t.shape[dim]
        return _gather_f32(group, t, dim)

    @staticmethod
    def backward(ctx, g):
        # gloo has no reduce-scatter: the sum whole, then this rank's slice
        total = _sum_f32(ctx.group, g)
        return (total.narrow(ctx.dim, ctx.group.index * ctx.size, ctx.size)
                .contiguous(), None, None)


class _VocabLogZ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lg, group):
        mx = torch.stack(group.all_gather(lg.amax(-1).contiguous())).amax(0)
        se = torch.exp(lg - mx[..., None]).sum(-1)
        logz = mx + torch.log(group.all_reduce_sum(se.contiguous()))
        ctx.save_for_backward(lg, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        lg, logz = ctx.saved_tensors
        return g[..., None] * torch.exp(lg - logz[..., None]), None
