"""The train step on one device, the port of ``repro/train/train_step.py``:
loss and gradients from autograd, optional microbatch accumulation, AdamW,
and the in-step egress for the in-transit sink (the paper's producer side).

What the reference adds for a mesh (the logical sharding rules, ZeRO-1, the
int8 error-feedback cross-pod reduction of ``compress_pods``) comes with the
multi-device slice: ``compress_pods=True`` raises here.

The step updates the state's parameters and moments in place and returns
the state with its new count and step. The egress holds only tensors the
step makes fresh (``diag``, ``blocks``, ``scales``), so a sink may keep
them until they are acknowledged while the next step runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.staging_pack import ops as pack_ops
from repro_torch.models.layers import ParamSpec, tree_leaves, tree_map
from repro_torch.models.model import Model
from repro_torch.models.transformer import unstack_scan_specs
from repro_torch.optim.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                         decay_mask)
from repro_torch.optim.schedule import warmup_cosine

Tree = Any
EGRESS = ("none", "diag", "grads_int8")
# grads_int8: each egress block is one (8, 128) tile of the first gradient
# leaf, quantized to int8 with its own scale
EGRESS_TILE = (8, 128)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_pods: bool = False      # int8 EF cross-pod gradient reduction
    egress: str = "diag"             # none | diag | grads_int8
    egress_blocks: int = 64          # int8 blocks sampled for egress
    xent_chunk: int = 512
    microbatches: int = 1            # gradient accumulation (activation
                                     # memory / microbatches; grads fp32)
    fsdp_experts: bool = False       # shards expert ffn on a mesh (no-op here)


def tree_unflatten(like: Tree, leaves: list) -> Tree:
    """``leaves`` (in ``tree_leaves`` order) put back in the shape of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def first_leaf(tree: Tree) -> torch.Tensor:
    """The reference's first leaf: the smallest key at each level (for every
    ported model, ``embed/table``)."""
    while isinstance(tree, dict):
        tree = tree[min(tree)]
    return tree


class TrainSetup:
    def __init__(self, model: Model, cfg: TrainConfig = TrainConfig()):
        if cfg.compress_pods:
            raise NotImplementedError(
                "compress_pods (the int8 cross-pod reduction) needs a mesh; "
                "it comes with the multi-device slice of the port")
        if cfg.egress not in EGRESS:
            raise ValueError(f"egress {cfg.egress!r} not in {EGRESS}")
        self.model = model
        self.cfg = cfg
        self.spec_tree = model.param_specs()       # the reference's, stacked
        self.decay = decay_mask(self.spec_tree, self.state_specs()["params"])

    # -- state ------------------------------------------------------------
    def state_specs(self) -> dict:
        """The state's specs in the port's layout: each ``scan`` entry a list
        of per-period specs (a checkpoint stores such a list stacked, as the
        reference's tree holds it)."""
        params = unstack_scan_specs(self.spec_tree, self.model.cfg)
        moment = tree_map(lambda s: ParamSpec(s.shape, torch.float32, "zeros"),
                          params)
        scalar = ParamSpec((), torch.int32, "zeros")
        return {"params": params,
                "opt": {"mu": moment, "nu": moment, "count": scalar},
                "step": scalar}

    def init_state(self, seed: int = 0,
                   device: str | torch.device = "cuda") -> dict:
        """Seeded params (``Model.init``), zero moments, count and step 0."""
        dev = resolve_device(device)
        params = self.model.init(seed, dev)
        return {"params": params, "opt": adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    # -- the step -----------------------------------------------------------
    def _value_and_grad(self, params: Tree, batch: dict):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = self.model.loss_fn(tree_unflatten(params, live), batch,
                                           xent_chunk=self.cfg.xent_chunk)
        grads = torch.autograd.grad(loss, live)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, list(grads)))

    def loss_and_grads(self, params: Tree, batch: dict):
        """(loss, metrics, grads) of the batch; with microbatches, the batch
        split on its leading axis, grads summed in f32 as acc + g/n and the
        loss and metrics averaged, in the reference's order."""
        n = self.cfg.microbatches
        if n == 1:
            return self._value_and_grad(params, batch)
        B = next(iter(batch.values())).shape[0]
        if B % n:
            raise ValueError(f"batch {B} is not a multiple of {n} microbatches")
        acc_l = acc_m = acc_g = None
        for i in range(n):
            mb = {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
            l, m, g = self._value_and_grad(params, mb)
            g = [x.float().div_(n) for x in tree_leaves(g)]
            if acc_g is None:          # the reference starts from zeros
                acc_g, acc_l = g, torch.zeros_like(l)
                acc_m = {k: torch.zeros_like(v) for k, v in m.items()}
            else:
                for a, x in zip(acc_g, g):
                    a.add_(x)
            del g
            acc_l = acc_l + l / n
            acc_m = {k: acc_m[k] + m[k] / n for k in m}
        return acc_l, acc_m, tree_unflatten(params, acc_g)

    def _egress(self, grads: Tree, loss: torch.Tensor,
                gnorm: torch.Tensor) -> dict:
        if self.cfg.egress == "none":
            return {}
        diag = torch.stack([loss.float(), gnorm])
        if self.cfg.egress == "diag":
            return {"diag": diag}
        # grads_int8: the first leaf's first nb*1024 elements as (nb*8, 128),
        # zero-filled, packed at tile (8, 128): the pack kernel on the card,
        # its plain version on the CPU
        nb = self.cfg.egress_blocks
        rows, lanes = nb * EGRESS_TILE[0], EGRESS_TILE[1]
        flat = first_leaf(grads).reshape(-1)[: rows * lanes].float().contiguous()
        blocks, scales = pack_ops.pack_flat(flat, (rows, lanes), EGRESS_TILE,
                                            torch.int8)
        return {"diag": diag, "blocks": blocks, "scales": scales}

    def step_fn(self) -> Callable:
        """train_step(state, batch) -> (state, metrics, egress)."""
        cfg = self.cfg

        def train_step(state: dict, batch: dict):
            lr = warmup_cosine(state["step"], peak_lr=cfg.peak_lr,
                               warmup_steps=cfg.warmup_steps,
                               total_steps=cfg.total_steps)
            loss, metrics, grads = self.loss_and_grads(state["params"], batch)
            params, opt, stats = adamw_update(grads, state["opt"],
                                              state["params"], lr, cfg.opt,
                                              self.decay)
            metrics = {**metrics, **stats, "loss": loss, "lr": lr}
            egress = self._egress(grads, loss, stats["grad_norm"])
            new_state = {"params": params, "opt": opt,
                         "step": state["step"] + 1}
            return new_state, metrics, egress

        return train_step
