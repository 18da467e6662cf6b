"""AdamW with global-norm clipping and ZeRO-1 state sharding, the port of
``repro/optim/optimizer.py``.

ZeRO-1 (``zero1=True``, on a mesh with more than one DP rank): each rank
keeps the first and second moments of each leaf only for its share of the
dimension the reference's ``_zero1_axes`` picks (the largest one whose
logical axis is None or ``layers`` and that the DP size divides), updates
its share of the parameter, and the shares are all-gathered. A leaf with
no such dimension keeps whole moments on every rank. In the port's layout a
``scan`` entry is a list of periods, so a split of the stacked ``layers``
axis makes each period's moments whole on one rank (``Zero1``). The DP
gradient reduction before it is an all-reduce (``train_step``), so the
global norm clips by the whole reduced gradient.

On a mesh with ``model`` > 1 each leaf is this rank's TP shard: ZeRO-1
splits the shard's local shape over its DP group, and ``global_norm``
takes a ``NormPlan``, which counts every element of the whole tree once
(sharded leaves summed over ``model``, a replicated leaf on one rank, KV
columns that ranks share on the first of them, and with ``fsdp_experts``
the expert leaves summed over ``data`` too). A leaf that ``fsdp_experts``
already shards over ``data`` keeps its moments whole for its share: the
reference's ``moment_constraint`` asks for a second split over the DP axes
there, which its ``try/except`` lets give way.

The update runs in place on the parameters and moments: the reference
returns new trees, and a framework that updates in place saves the copy of
every parameter and moment (37 GB at gemma2-27b's full width with two
layers).

Weight decay follows the reference's test ``p.ndim > 1`` on *its* leaves.
Its ``scan`` entries are stacked on a periods axis, so a norm scale there is
(n_periods, d_model) and is decayed, while in the ``rem`` layout it is 1-D
and is not. The port holds ``scan`` entries as per-period 1-D tensors, so
``decay_mask`` reads the decision from the reference's stacked specs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models.layers import ParamSpec, tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    zero1: bool = True


def decay_mask(spec_tree: Tree, params: Tree) -> Tree:
    """A tree like ``params`` of bools: True where the reference decays the
    leaf, i.e. where its spec (stacked for ``scan`` entries) has ndim > 1.
    A list in ``params`` (a ``scan`` entry's periods) shares one spec tree."""
    if isinstance(params, list):
        return [decay_mask(spec_tree, p) for p in params]
    if isinstance(spec_tree, ParamSpec):
        return len(spec_tree.shape) > 1
    return {k: decay_mask(spec_tree[k], params[k]) for k in params}


def adamw_init(params: Tree) -> dict:
    """Zero f32 moments like ``params`` and a step count of 0 (int32)."""
    leaf = tree_leaves(params)[0]
    return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


@dataclasses.dataclass
class NormPlan:
    """How ``global_norm`` counts a sharded tree, leaf by leaf in
    ``tree_leaves`` order: ``counted[i]`` None (the whole local leaf) or
    the local cuts this rank counts (``train.sharding.counted_cuts``; a
    dimension with no range counts nothing); ``split[i]`` True where the
    leaf is cut over ``data`` (its sum runs over ``data`` as well); and
    the ``model`` and ``data`` groups the sums run over."""
    counted: list
    split: list
    model: Any
    data: Any


def global_norm(grads: Tree, plan: Optional[NormPlan] = None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g**2), in f32; with a ``plan``,
    of the whole tree whose shards the ranks hold (the same value on every
    rank)."""
    leaves = tree_leaves(grads)
    if plan is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    from repro_torch.train.sharding import take
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    sums = [zero, zero]                       # [replicated over data, split]
    for g, cuts, split in zip(leaves, plan.counted, plan.split):
        if cuts is not None:
            if any(not ranges for ranges in cuts):
                continue
            g = take(g, cuts)
        sums[split] = sums[split] + torch.sum(torch.square(g.float()))
    total = sums[0]
    if any(plan.split):
        total = total + plan.data.all_reduce_sum(sums[1].clone())
    return torch.sqrt(plan.model.all_reduce_sum(total.clone()))


def zero1_axes(axes: tuple, shape: tuple, dp_size: int) -> Optional[int]:
    """The reference's ``_zero1_axes``: the index of the largest dimension
    whose logical axis is None or ``layers`` and which ``dp_size`` divides;
    None where there is none."""
    best, best_size = None, 0
    for i, (a, n) in enumerate(zip(axes, shape)):
        if a in (None, "layers") and n % dp_size == 0 and n > best_size:
            best, best_size = i, n
    return best


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf's ZeRO-1 split in the port's layout: ``full`` on every rank,
    a share of dimension ``arg`` on each rank (``dim``), or whole on the DP
    rank ``arg`` that owns its period (``owner``)."""
    kind: str
    arg: int = 0


FULL = Split("full")


def zero1_plan(spec_tree: Tree, params: Tree, dp_size: int,
               rules: Optional[dict] = None) -> Tree:
    """A tree like ``params`` of ``Split``s, from the reference's (stacked)
    ``spec_tree`` (on a mesh with ``model`` > 1, its local shapes). With
    ``rules``, a leaf they already cut over a DP axis stays whole."""
    def taken(spec) -> bool:
        for a in spec.axes or ():
            rule = rules.get(a) if rules and a else None
            if set((rule,) if isinstance(rule, str) else rule or ()) & {"pod", "data"}:
                return True
        return False

    def leaf(spec, period):
        d = zero1_axes(spec.axes, spec.shape, dp_size) if dp_size > 1 else None
        if d is None or taken(spec):
            return FULL
        if period is None:
            return Split("dim", d)
        i, n = period
        return Split("owner", i // (n // dp_size)) if d == 0 else Split("dim", d - 1)

    def walk(spec, p, period=None):
        if isinstance(p, list):
            return [walk(spec, pp, (i, len(p))) for i, pp in enumerate(p)]
        if isinstance(p, dict):
            return {k: walk(spec[k], p[k], period) for k in p}
        return leaf(spec, period)

    return walk(spec_tree, params)


class Zero1:
    """ZeRO-1 over a mesh's DP group: which share of each leaf this rank
    keeps moments for and updates (``plan``, in ``tree_leaves`` order), and
    the collectives that put the shares together."""

    def __init__(self, spec_tree: Tree, params: Tree, dp,
                 rules: Optional[dict] = None):
        self.dp = dp
        self.plan = tree_leaves(zero1_plan(spec_tree, params, dp.size, rules))

    def share(self, t: torch.Tensor, split: Split) -> Optional[torch.Tensor]:
        """This rank's share of a whole leaf (a view), None where another
        rank owns it."""
        if split.kind == "dim":
            n = t.shape[split.arg] // self.dp.size
            return t.narrow(split.arg, self.dp.index * n, n)
        if split.kind == "owner":
            return t if split.arg == self.dp.index else None
        return t

    def local(self, whole: Tree) -> Tree:
        """Whole moments -> this rank's shares (copies); an owned-elsewhere
        period's moments become an empty tensor."""
        it = iter(self.plan)

        def one(t):
            part = self.share(t, next(it))
            return (t.new_zeros((0,)) if part is None
                    else part.clone(memory_format=torch.contiguous_format))

        return tree_map(one, whole)

    def whole(self, local: Tree, like: Tree, root: Optional[int] = None) -> Optional[Tree]:
        """This rank's moment shares -> the whole moments, shaped as the
        leaves of ``like``, on every rank (collective); with ``root``, on
        the DP group's ``root``-th rank alone, and None on the others."""
        it = iter(self.plan)
        mine = root is None or self.dp.index == root

        def one(m, p):
            split = next(it)
            if split.kind == "dim":
                m = m.contiguous()
                parts = (self.dp.all_gather(m) if root is None
                         else self.dp.gather(m, root))
                return None if parts is None else torch.cat(parts, split.arg)
            if split.kind == "owner":
                owner = split.arg == self.dp.index
                if not (mine or owner):
                    return None
                out = m if owner else torch.empty(p.shape, dtype=torch.float32,
                                                  device=p.device)
                if root is None:
                    return self.dp.broadcast(out, split.arg)
                return self.dp.send_to(out, split.arg, root)
            return m

        leaves = [one(m, p) for m, p in zip(tree_leaves(local), tree_leaves(like))]
        if not mine:
            return None
        it_leaves = iter(leaves)
        return tree_map(lambda _: next(it_leaves), like)

    def gather_params(self, params: Tree) -> None:
        """After each rank updated its shares: every rank's params whole
        again, in place."""
        for p, split in zip(tree_leaves(params), self.plan):
            if split.kind == "dim":
                parts = self.dp.all_gather(self.share(p, split).contiguous())
                p.copy_(torch.cat(parts, split.arg))
            elif split.kind == "owner":
                self.dp.broadcast(p, split.arg)


def _adamw_leaf(g, m, v, p, decay: bool, scale, lr, bc1, bc2,
                cfg: AdamWConfig) -> None:
    g = g.float() * scale
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    del g
    den = torch.div(v, bc2).sqrt_().add_(cfg.eps)       # sqrt(vhat) + eps
    step = torch.div(m, bc1).div_(den)                  # mhat / den
    del den
    if decay:
        step.add_(cfg.weight_decay * p.float())
    step.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_(p.float() - step)


@torch.no_grad()
def adamw_update(grads: Tree, state: dict, params: Tree, lr: torch.Tensor,
                 cfg: AdamWConfig, decay: Tree, zero1: Optional[Zero1] = None,
                 norm: Optional[NormPlan] = None):
    """One AdamW step: clip by the global norm (over the mesh's shards with
    ``norm``), update the f32 moments, correct their bias with the count
    starting at 1, decay where ``decay`` says. Updates ``params``,
    ``state["mu"]`` and ``state["nu"]`` in place and leaves ``grads`` as
    they are. With ``zero1`` each rank updates its share of each leaf
    (``grads`` whole, the moments its shares) and the params are gathered.
    Returns (params, state, {"grad_norm", "clip_scale"}), the state with
    the new count."""
    count = state["count"] + 1
    gnorm = global_norm(grads, norm)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    c = count.to(torch.float32)
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32, device=c.device) ** c
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32, device=c.device) ** c
    plan = zero1.plan if zero1 is not None else None
    for i, (g, m, v, p, d) in enumerate(zip(
            tree_leaves(grads), tree_leaves(state["mu"]),
            tree_leaves(state["nu"]), tree_leaves(params), tree_leaves(decay))):
        if plan is not None and plan[i] != FULL:
            g, p = zero1.share(g, plan[i]), zero1.share(p, plan[i])
            if p is None:            # a period another rank owns
                continue
        _adamw_leaf(g, m, v, p, d, scale, lr, bc1, bc2, cfg)
    if zero1 is not None:
        zero1.gather_params(params)
    new_state = {"mu": state["mu"], "nu": state["nu"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "clip_scale": scale}
