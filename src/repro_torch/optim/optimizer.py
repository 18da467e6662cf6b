"""AdamW with global-norm clipping, the port of ``repro/optim/optimizer.py``
on one device.

The reference's ZeRO-1 option is a sharding constraint on the moments,
which does nothing on one device; ``zero1`` is kept in the config for the
multi-device slice. The update runs in place on the parameters and moments:
the reference returns new trees, and a framework that updates in place
saves the copy of every parameter and moment (37 GB at gemma2-27b's full
width with two layers).

Weight decay follows the reference's test ``p.ndim > 1`` on *its* leaves.
Its ``scan`` entries are stacked on a periods axis, so a norm scale there is
(n_periods, d_model) and is decayed, while in the ``rem`` layout it is 1-D
and is not. The port holds ``scan`` entries as per-period 1-D tensors, so
``decay_mask`` reads the decision from the reference's stacked specs.
"""
from __future__ import annotations

import dataclasses
from typing import Any

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


def global_norm(grads: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g**2), in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


@torch.no_grad()
def adamw_update(grads: Tree, state: dict, params: Tree, lr: torch.Tensor,
                 cfg: AdamWConfig, decay: Tree):
    """One AdamW step: clip by the global norm, update the f32 moments,
    correct their bias with the count starting at 1, decay where ``decay``
    says. Updates ``params``, ``state["mu"]`` and ``state["nu"]`` in place
    and leaves ``grads`` as they are. Returns (params, state, {"grad_norm",
    "clip_scale"}), the state with the new count."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    c = count.to(torch.float32)
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32, device=c.device) ** c
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32, device=c.device) ** c
    for g, m, v, p, d in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                             tree_leaves(state["nu"]), tree_leaves(params),
                             tree_leaves(decay)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        den = torch.div(v, bc2).sqrt_().add_(cfg.eps)       # sqrt(vhat) + eps
        step = torch.div(m, bc1).div_(den)                  # mhat / den
        del den
        if d:
            step.add_(cfg.weight_decay * p.float())
        step.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(step)
        else:
            p.copy_(p.float() - step)
    new_state = {"mu": state["mu"], "nu": state["nu"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "clip_scale": scale}
