"""The train step, the port of ``repro/train/train_step.py``: loss and
gradients from autograd, optional microbatch accumulation, AdamW (ZeRO-1 on
a mesh), the int8 error-feedback cross-pod reduction of ``compress_pods``,
and the in-step egress for the in-transit sink (the paper's producer side).

On a mesh (``launch.mesh.Mesh``, one process a rank) each rank holds its
shard of the params (``Model.init`` with the mesh's rules): with ``model``
> 1 its TP/EP shard, the layers meeting over ``model`` through the autograd
collectives of ``sharding.TPContext``; with ``fsdp_experts`` the expert
weights' ffn axis over ``data`` too. After the backward, the gradients that
ranks of a ``model`` group hold in part (KV heads they share, the q/k norm
scales) are summed over the group (``sharding.shared_over_model``). The
step then follows the reference's three branches:
  * compressed (``compress_pods`` and more than one pod): grads on this
    rank's rows, their f32 mean over ``data``, then ``_pod_reduce`` over
    ``pod``, an int8 ring reduce-scatter + all-gather with an error-feedback
    residual ``err`` kept in the state. As in the reference, this branch
    takes no microbatches. The reference flattens the whole tree and keeps
    ``err`` replicated over ``model``: with ``model`` > 1 (or
    ``fsdp_experts``) each rank puts the whole gradients together
    (``sharding.unshard``), reduces the whole flat (the same bits on every
    rank of a pod) and keeps its own cut of it;
  * microbatched DP and plain DP: grads (accumulated over microbatches)
    all-reduced to their f32 mean over the DP axes, each rank its TP shard.
    An ``fsdp_experts`` leaf is already summed over ``data`` by its
    gather's backward, so it is summed over ``pod`` alone.
Loss and metrics are averaged over the DP ranks. The reference's loss is
the masked mean over the whole (micro)batch, ``nll_sum / m_sum``; so each
rank divides its masked sums by its share of the global count (the
(micro)batch's unmasked tokens summed over the DP ranks before the step,
one all-reduce, over the DP size), and the DP mean of loss, metrics and
gradients is the global masked mean whatever each rank's count. The MoE
aux losses are token means over equal row counts. With microbatches a
rank's rows are its DP share of each global microbatch in turn
(``sharding.batch_rows``), as the reference puts DP on each microbatch
of the global batch, so anything nonlinear in a microbatch (the masked
mean, MoE's load-balance term) sees the reference's rows. Every rank then
holds the same reduced
gradients (its shard of them), the AdamW update (each rank its ZeRO-1
share) and the same params. The egress is computed from the reduced grads
on rank 0 alone; with ``grads_int8`` on a TP mesh the first leaf's sample
is gathered there from the ranks of its ``model`` group.

The step updates the state's parameters and moments in place and returns
the state with its new count and step. The egress holds only tensors the
step makes fresh (``diag``, ``blocks``, ``scales``), so a sink may keep
them until they are acknowledged while the next step runs.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.staging_pack import ops as pack_ops
from repro_torch.models.layers import ParamSpec, tree_leaves, tree_map
from repro_torch.models.model import Model
from repro_torch.models.transformer import unstack_scan_specs
from repro_torch.optim import grad_compress as gc
from repro_torch.optim.optimizer import (AdamWConfig, NormPlan, Zero1,
                                         adamw_init, adamw_update, decay_mask)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.sharding import (TPContext, counted_cuts, local_slice,
                                        local_specs, make_rules, mesh_axes,
                                        shard_batch, shard_tree,
                                        shared_over_model, take, unshard)

Tree = Any
EGRESS = ("none", "diag", "grads_int8")
# grads_int8: each egress block is one (8, 128) tile of the first gradient
# leaf, quantized to int8 with its own scale
EGRESS_TILE = (8, 128)
# bytes a rank put on the cross-pod wire in ``_pod_reduce`` (int8 shards and
# their scales, reduce-scatter and all-gather), counted from the buffers
# sent and received; read and reset by the caller
POD_WIRE = {"bytes": 0}


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
    fsdp_experts: bool = False       # shard expert ffn dim over `data`
                                     # (FSDP: per-layer weight all-gather;
                                     # required for 400B+ MoE to fit HBM)


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


def _dp_mean(group, t: torch.Tensor) -> torch.Tensor:
    """In place: ``t``'s f32 mean over ``group``'s ranks."""
    if group.size > 1:
        group.all_reduce_sum(t).div_(group.size)
    return t


class TrainSetup:
    def __init__(self, model: Model, cfg: TrainConfig = TrainConfig(),
                 mesh=None):
        if cfg.egress not in EGRESS:
            raise ValueError(f"egress {cfg.egress!r} not in {EGRESS}")
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.spec_tree = model.param_specs()       # the reference's, stacked
        # the whole params' specs in the port's layout (scan entries per period)
        self.param_specs = unstack_scan_specs(self.spec_tree, model.cfg)
        self.decay = decay_mask(self.spec_tree, self.param_specs)
        self.tp = self.zero1 = self.norm = None
        self.compress = self.sharded = False
        n_leaves = len(tree_leaves(self.param_specs))
        # which leaves the ranks of a model group each hold in part, and
        # which fsdp_experts cuts over data (none off a TP/FSDP mesh)
        self.shared, self.fsdp_leaf = [False] * n_leaves, [False] * n_leaves
        if mesh is None:
            self.rules = None
            if cfg.compress_pods:
                raise ValueError("compress_pods reduces over the pods of a "
                                 "mesh: pass mesh=")
            return
        self.rules = make_rules(mesh, model.cfg)
        if cfg.fsdp_experts:
            self.rules["expert_ffn"] = "data"
        mcfg = model.cfg
        specs = tree_leaves(self.param_specs)
        # where the whole tree is cut over the mesh, and how (leaf by leaf)
        self.sharded = any(mesh.shape[a] > 1 for s in specs
                           for a in mesh_axes(s, self.rules))
        self.tp = TPContext(mesh, self.rules, mcfg)
        if mesh.shape.get("model", 1) > 1 or self.sharded:
            self.shared = [shared_over_model(s, mesh, self.rules, mcfg)
                           for s in specs]
            self.fsdp_leaf = [mesh.shape.get("data", 1) > 1
                              and "data" in mesh_axes(s, self.rules)
                              for s in specs]
            self.norm = NormPlan(
                counted=[counted_cuts(s, mesh, self.rules, mcfg) for s in specs],
                split=self.fsdp_leaf, model=mesh.groups["model"],
                data=mesh.groups["data"])
        self.compress = cfg.compress_pods and mesh.shape.get("pod", 1) > 1
        if cfg.opt.zero1 and mesh.dp.size > 1:
            local = local_specs(self.spec_tree, mesh, self.rules, mcfg)
            self.zero1 = Zero1(local, unstack_scan_specs(local, mcfg), mesh.dp,
                               self.rules)

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of the global ``batch`` for this step
        (``sharding.shard_batch`` with the config's microbatches)."""
        if self.mesh is None:
            return batch
        return shard_batch(self.mesh, self.rules, batch, self.cfg.microbatches)

    @property
    def n_pods(self) -> int:
        return self.mesh.shape["pod"] if self.compress else 1

    # -- state ------------------------------------------------------------
    def state_specs(self) -> dict:
        """The whole state's specs in the port's layout (what a checkpoint
        holds): each ``scan`` entry a list of per-period specs (stored
        stacked, as the reference's tree holds it), whole moments, and with
        ``compress_pods`` each pod's residual, (n_pods, rows, QBLOCK)."""
        params = self.param_specs
        moment = tree_map(lambda s: ParamSpec(s.shape, torch.float32, "zeros"),
                          params)
        scalar = ParamSpec((), torch.int32, "zeros")
        specs = {"params": params,
                 "opt": {"mu": moment, "nu": moment, "count": scalar},
                 "step": scalar}
        if self.compress:
            specs["err"] = ParamSpec(
                (self.n_pods, *gc.error_state(params, self.n_pods)),
                torch.float32, "zeros")
        return specs

    def init_state(self, seed: int = 0,
                   device: str | torch.device = "cuda") -> dict:
        """Seeded params (``Model.init``: every rank draws the one-device
        init and keeps its shard), zero moments (this rank's ZeRO-1 shares),
        count and step 0, and with ``compress_pods`` this pod's zero
        residual (of the whole tree)."""
        dev = resolve_device(device)
        return self._state(self.model.init(seed, dev, self.mesh, self.rules))

    def abstract_state(self) -> dict:
        """``init_state``'s state as meta tensors: this rank's params,
        ZeRO-1 moment shares, count, step and residual, shapes and dtypes
        alone (the dry run's arguments)."""
        return self._state(self.model.abstract_params(self.mesh, self.rules))

    def _state(self, params: Tree) -> dict:
        dev = first_leaf(params).device
        opt = adamw_init(params)
        if self.zero1 is not None:
            opt = {"mu": self.zero1.local(opt["mu"]),
                   "nu": self.zero1.local(opt["nu"]), "count": opt["count"]}
        state = {"params": params, "opt": opt,
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.compress:
            state["err"] = torch.zeros(
                gc.error_state(self.param_specs, self.n_pods),
                dtype=torch.float32, device=dev)
        return state

    def _unshard_tree(self, tree: Tree, axes: tuple, dst: Optional[int] = None):
        """Each leaf whole over the mesh ``axes`` that cut it (collective;
        with ``dst`` on the groups' ``dst``-th ranks alone, None elsewhere)."""
        specs = tree_leaves(self.param_specs)
        leaves = [unshard(t, s, self.mesh, self.rules, self.model.cfg, axes, dst)
                  for t, s in zip(tree_leaves(tree), specs)]
        if any(x is None for x in leaves):
            return None
        return tree_unflatten(tree, leaves)

    def whole_state(self, state: dict, root: bool = False) -> Optional[dict]:
        """This rank's state -> the whole state of ``state_specs`` on every
        rank: moments gathered over the DP ranks, each pod's residual
        gathered over the pods, params and moments put together over the
        ranks that shard them (collective on a mesh). With ``root``, the
        whole state reaches the mesh's rank 0 alone (a checkpoint's writer)
        and every other rank gets None."""
        if self.mesh is None:
            return state
        mesh, opt = self.mesh, state["opt"]
        params, mu, nu = state["params"], opt["mu"], opt["nu"]
        dst = 0 if root else None          # rank 0 is first in every group
        if self.sharded and mesh.shape.get("data", 1) > 1:
            # fsdp_experts' shares over data, on every rank (ZeRO-1 keeps
            # their moments whole, so the DP gather below passes them by)
            params, mu, nu = (self._unshard_tree(t, ("data",))
                              for t in (params, mu, nu))
        if self.zero1 is not None:
            mu = self.zero1.whole(mu, params, dst)
            nu = self.zero1.whole(nu, params, dst)
        err = None
        if self.compress:
            pod = mesh.groups["pod"]
            if not root:
                err = torch.stack(pod.all_gather(state["err"]))
            elif mesh.coords["data"] == 0 and mesh.coords["model"] == 0:
                parts = pod.gather(state["err"], 0)   # rank 0's pod group
                err = None if parts is None else torch.stack(parts)
        if root and mesh.dp.index != 0:
            return None
        if self.sharded:             # over model, within the DP root's group
            params, mu, nu = (self._unshard_tree(t, ("model",), dst)
                              for t in (params, mu, nu))
        if root and mesh.rank != 0:
            return None
        whole = {**state, "params": params,
                 "opt": {"mu": mu, "nu": nu, "count": opt["count"]}}
        if self.compress:
            whole["err"] = err
        return whole

    def local_state(self, whole: dict) -> dict:
        """The whole state (as a checkpoint restores it, on any mesh's
        layout) -> this rank's: its shard of the params and moments, its
        ZeRO-1 shares of the moments and its pod's residual."""
        if self.mesh is None:
            return whole
        opt = whole["opt"]
        params, mu, nu = whole["params"], opt["mu"], opt["nu"]
        if self.sharded:
            params, mu, nu = (shard_tree(t, self.param_specs, self.mesh,
                                         self.rules, self.model.cfg)
                              for t in (params, mu, nu))
        if self.zero1 is not None:
            mu, nu = self.zero1.local(mu), self.zero1.local(nu)
        local = {**whole, "params": params,
                 "opt": {"mu": mu, "nu": nu, "count": opt["count"]}}
        if self.compress:
            local["err"] = whole["err"][self.mesh.coords["pod"]].clone()
        return local

    # -- the step -----------------------------------------------------------
    def _value_and_grad(self, params: Tree, batch: dict, denom=None):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = self.model.loss_fn(tree_unflatten(params, live), batch,
                                           xent_chunk=self.cfg.xent_chunk,
                                           tp=self.tp, denom=denom)
        grads = torch.autograd.grad(loss, live)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, list(grads)))

    def _denoms(self, batch: dict, group, n: int) -> Optional[torch.Tensor]:
        """Each of the ``n`` microbatches' share of its global unmasked
        count: the counts of this rank's rows summed over ``group`` (the
        DP ranks), at least 1, over the group's size; None off a DP mesh
        (the loss divides by its own count, bit for bit as before)."""
        if group is None or group.size == 1:
            return None
        mask = batch["loss_mask"]
        counts = mask.float().reshape(n, -1).sum(1)
        return torch.clamp(group.all_reduce_sum(counts), min=1.0) / group.size

    def loss_and_grads(self, params: Tree, batch: dict, denoms=None):
        """(loss, metrics, grads) of the batch; with microbatches, the batch
        split on its leading axis, grads summed in f32 as acc + g/n and the
        loss and metrics averaged, in the reference's order. ``denoms``:
        each microbatch's masked-mean divisor (``_denoms``) or None."""
        n = self.cfg.microbatches
        if n == 1:
            return self._value_and_grad(params, batch,
                                        None if denoms is None else denoms[0])
        B = next(iter(batch.values())).shape[0]
        if B % n:
            raise ValueError(f"batch {B} is not a multiple of {n} microbatches")
        acc_l = acc_m = acc_g = None
        for i in range(n):
            mb = {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
            l, m, g = self._value_and_grad(params, mb,
                                           None if denoms is None else denoms[i])
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

    def _sum_shared(self, leaves: list) -> list:
        """The gradients that the ranks of a ``model`` group hold in part
        (``shared``) summed over the group, in f32 and rounded once, each
        rank keeping its cut: one all-reduce of every such leaf placed in
        its whole shape."""
        idx = [i for i, sh in enumerate(self.shared) if sh]
        if not idx:
            return leaves
        specs, cfg = tree_leaves(self.param_specs), self.model.cfg
        cuts, bufs = {}, []
        for i in idx:
            spec = specs[i]
            cuts[i] = local_slice(spec, self.mesh, self.rules, cfg)
            whole = torch.zeros(spec.shape, dtype=torch.float32,
                                device=leaves[i].device)
            take(whole, cuts[i]).copy_(leaves[i])     # one range a dimension
            bufs.append(whole)
        flat = self.mesh.groups["model"].all_reduce_sum(
            torch.cat([b.reshape(-1) for b in bufs]))
        out, off = leaves, 0
        for i, b in zip(idx, bufs):
            whole = flat[off:off + b.numel()].view(b.shape)
            off += b.numel()
            out[i] = take(whole, cuts[i]).to(leaves[i].dtype)
        return out

    def _dp_mean_leaves(self, leaves: list, group, rest=None) -> list:
        """Each leaf's f32 mean over ``group``'s ranks, in place in the list
        ``leaves`` (a leaf is freed once it is copied into the flat buffer,
        where the caller holds no other reference). A leaf that
        ``fsdp_experts`` shards over ``data`` comes summed over ``data``
        already: it is summed over ``rest`` alone (the group's other axis,
        or None) and divided."""
        plain = [i for i, f in enumerate(self.fsdp_leaf) if not f]
        if plain:
            like = [torch.empty(leaves[i].shape, dtype=leaves[i].dtype,
                                device="meta") for i in plain]
            sub = [leaves[i] for i in plain]
            for i in plain:
                leaves[i] = None
            flat, pad = gc.flatten(sub)                   # frees each leaf
            _dp_mean(group, flat)
            for i, g in zip(plain, gc.unflatten(flat, pad, like)):
                leaves[i] = g
        for i, f in enumerate(self.fsdp_leaf):
            if f:
                g = leaves[i].float()
                if rest is not None and rest.size > 1:
                    g = rest.all_reduce_sum(g.clone())
                leaves[i] = g.div_(group.size).to(leaves[i].dtype)
        return leaves

    def _first_sample(self, grads: Tree, n: int) -> Optional[torch.Tensor]:
        """The first ``n`` values of the whole first leaf's gradient,
        flattened (zero past its end): on a TP mesh the ranks of the DP
        root's ``model`` group each place the part of it they count, and
        rank 0 sums them; every other rank gets None."""
        g = first_leaf(grads)
        if self.tp is None or self.mesh.shape["model"] == 1:
            return g.reshape(-1)[:n]
        spec = first_leaf(self.param_specs)
        inner = math.prod(spec.shape[1:])
        rows = min(spec.shape[0], -(-n // inner))
        box = torch.zeros((rows, *spec.shape[1:]), dtype=torch.float32,
                          device=g.device)
        mine = local_slice(spec, self.mesh, self.rules, self.model.cfg)
        counted = self.norm.counted[0] or [[(0, k)] for k in g.shape]
        segs = [_to_whole(m, c) for m, c in zip(mine, counted)]
        for combo in itertools.product(*segs):   # (whole, local, length) a dim
            dst, src = box, g
            for d, (w, l, k) in enumerate(combo):
                if d == 0:
                    k = min(k, rows - w)
                if k <= 0:
                    break
                dst, src = dst.narrow(d, w, k), src.narrow(d, l, k)
            else:
                dst.copy_(src)
        parts = self.mesh.groups["model"].gather(box, 0)
        if parts is None:
            return None
        return torch.stack(parts).sum(0).reshape(-1)[:n]

    def _egress(self, grads: Tree, loss: torch.Tensor, gnorm: torch.Tensor,
                sample: Optional[torch.Tensor] = None) -> dict:
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
        if sample is None:
            sample = first_leaf(grads).reshape(-1)[: rows * lanes]
        flat = sample.float().contiguous()
        blocks, scales = pack_ops.pack_flat(flat, (rows, lanes), EGRESS_TILE,
                                            torch.int8)
        return {"diag": diag, "blocks": blocks, "scales": scales}

    def _compressed_grads(self, state: dict, batch: dict):
        """The compressed branch: this pod's grads, their f32 mean over
        ``data``, the int8 ring over ``pod`` (``state["err"]`` moves on in
        place). On a sharded mesh the ring takes the whole tree's flat, put
        together on every rank, and each rank keeps its cut."""
        mesh = self.mesh
        denom = self._denoms(batch, mesh.groups["data"], 1)
        loss, metrics, grads = self._value_and_grad(
            state["params"], batch, None if denom is None else denom[0])
        leaves = self._sum_shared(tree_leaves(grads))
        del grads
        if not self.sharded:
            flat, pad = gc.flatten(leaves, self.n_pods)     # frees the grads
            _dp_mean(mesh.groups["data"], flat)
            flat, _ = _pod_reduce(flat, state["err"], mesh.groups["pod"])
            return loss, metrics, gc.unflatten(flat, pad, state["params"])
        leaves = self._dp_mean_leaves(leaves, mesh.groups["data"])
        specs, cfg = tree_leaves(self.param_specs), self.model.cfg
        whole = [unshard(g, s, mesh, self.rules, cfg) for g, s in zip(leaves, specs)]
        like = [torch.empty(s.shape, dtype=g.dtype, device="meta")
                for g, s in zip(leaves, specs)]
        del leaves
        flat, pad = gc.flatten(whole, self.n_pods)          # frees the wholes
        flat, _ = _pod_reduce(flat, state["err"], mesh.groups["pod"])
        cut = [take(g, local_slice(s, mesh, self.rules, cfg))
               for g, s in zip(gc.unflatten(flat, pad, like), specs)]
        return loss, metrics, tree_unflatten(state["params"], cut)

    def reduced_loss_and_grads(self, state: dict, batch: dict):
        """(loss, metrics, grads) with the grads reduced over the mesh by the
        branch the config picks (module docstring), from this rank's rows in
        ``batch``; on a compressed mesh ``state["err"]`` moves on a step, in
        place."""
        mesh = self.mesh
        if self.compress:
            loss, metrics, grads = self._compressed_grads(state, batch)
        else:
            denoms = (None if mesh is None else
                      self._denoms(batch, mesh.dp, self.cfg.microbatches))
            loss, metrics, grads = self.loss_and_grads(state["params"], batch,
                                                       denoms)
            if mesh is not None:
                leaves = self._sum_shared(tree_leaves(grads))
                del grads
                if mesh.dp.size > 1:
                    leaves = self._dp_mean_leaves(leaves, mesh.dp,
                                                  mesh.groups.get("pod"))
                grads = tree_unflatten(state["params"], leaves)
        if mesh is not None and mesh.dp.size > 1:
            keys = sorted(metrics)
            scalars = _dp_mean(mesh.dp, torch.stack(
                [loss.float(), *(metrics[k].float() for k in keys)]))
            loss, metrics = scalars[0], dict(zip(keys, scalars[1:]))
        return loss, metrics, grads

    def step_fn(self) -> Callable:
        """train_step(state, batch) -> (state, metrics, egress); ``batch``
        holds this rank's rows (``shard_batch``). The egress is {} on every
        rank but rank 0."""
        cfg = self.cfg
        mesh = self.mesh
        egress_rank = mesh is None or mesh.rank == 0
        # the ranks the grads_int8 sample is gathered from: the DP root's
        # model group
        sample_ranks = mesh is None or mesh.dp.index == 0
        n_sample = cfg.egress_blocks * EGRESS_TILE[0] * EGRESS_TILE[1]

        def train_step(state: dict, batch: dict):
            lr = warmup_cosine(state["step"], peak_lr=cfg.peak_lr,
                               warmup_steps=cfg.warmup_steps,
                               total_steps=cfg.total_steps)
            loss, metrics, grads = self.reduced_loss_and_grads(state, batch)
            params, opt, stats = adamw_update(grads, state["opt"],
                                              state["params"], lr, cfg.opt,
                                              self.decay, self.zero1, self.norm)
            metrics = {**metrics, **stats, "loss": loss, "lr": lr}
            sample = (self._first_sample(grads, n_sample)
                      if cfg.egress == "grads_int8" and sample_ranks else None)
            egress = (self._egress(grads, loss, stats["grad_norm"], sample)
                      if egress_rank else {})
            new_state = {"params": params, "opt": opt,
                         "step": state["step"] + 1}
            if self.compress:
                new_state["err"] = state["err"]
            return new_state, metrics, egress

        return train_step


def _to_whole(mine: list, local: list) -> list:
    """Local ranges of a dimension (``local``) as (whole start, local start,
    length) segments, where this rank's share holds the whole ranges
    ``mine`` side by side."""
    out, off = [], 0
    for a, b in mine:
        for la, lb in local:
            lo, hi = max(la, off), min(lb, off + b - a)
            if lo < hi:
                out.append((a + lo - off, lo, hi - lo))
        off += b - a
    return out


# -- the cross-pod ring --------------------------------------------------------


def _to_wire(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 rows and their f32 scales as one host byte buffer (pinned for a
    CUDA source): q's bytes, then s's."""
    nq = q.numel()
    buf = torch.empty(nq + 4 * s.numel(), dtype=torch.uint8,
                      pin_memory=q.device.type == "cuda")
    buf[:nq].view(torch.int8).view(q.shape).copy_(q)
    buf[nq:].view(torch.float32).copy_(s)
    return buf


def _from_wire(buf: torch.Tensor, rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    nq = rows * gc.QBLOCK
    return (buf[:nq].view(torch.int8).view(rows, gc.QBLOCK).to(device),
            buf[nq:].view(torch.float32).to(device))


def _ring_hop(group, q: torch.Tensor, s: torch.Tensor, to: int,
              frm: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Send this pod's int8 rows ``q`` and scales ``s`` of pod ``to``'s shard
    to it, and receive pod ``frm``'s rows of this pod's shard: one hop of the
    reduce-scatter, host copies included."""
    send = _to_wire(q, s)
    recv = torch.empty(send.shape, dtype=send.dtype, pin_memory=send.is_pinned())
    group.exchange(send, to, recv, frm)
    POD_WIRE["bytes"] += send.numel()
    return _from_wire(recv, q.shape[0], q.device)


def _gather_shards(group, q: torch.Tensor, s: torch.Tensor) -> list:
    """Every pod's reduced int8 shard and scales, in pod order: the
    all-gather, host copies included."""
    bufs = group.all_gather(_to_wire(q, s))
    POD_WIRE["bytes"] += sum(b.numel() for k, b in enumerate(bufs) if k != group.index)
    return [_from_wire(b, q.shape[0], q.device) for b in bufs]


def _residual_(err: torch.Tensor, g: torch.Tensor, q: torch.Tensor,
               s: torch.Tensor) -> None:
    """err = g - q.float() * s[:, None], a chunk of rows at a time."""
    for a in range(0, g.shape[0], gc.CHUNK_ROWS):
        b = a + gc.CHUNK_ROWS
        torch.sub(g[a:b], gc.dequant_blocks(q[a:b], s[a:b]), out=err[a:b])


def _add_dequant_(acc: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    """acc += q.float() * s[:, None], a chunk of rows at a time."""
    for a in range(0, acc.shape[0], gc.CHUNK_ROWS):
        b = a + gc.CHUNK_ROWS
        acc[a:b].add_(gc.dequant_blocks(q[a:b], s[a:b]))


def _pod_reduce(flat: torch.Tensor, err: torch.Tensor, group):
    """int8 ring reduce-scatter + all-gather over ``pod`` with error feedback,
    the reference's ``_pod_reduce`` on a gloo group. ``flat``: this pod's
    (rows, QBLOCK) f32 grads, rows a multiple of the pods; ``err``: its
    residual. Returns (reduced, new_err), the reduced grads the same bits on
    every pod. Works in place: ``flat`` becomes the reduced grads and
    ``err`` the new residual.

    Each pod quantizes g = flat + err (the residual g - dq(g) stays), owns
    rows [p·R/n, (p+1)·R/n), and sums the dequantized shards in the order
    the reference's ``ppermute`` ring delivers them: its own, then pod
    p-1's, p-2's, ...; divides by n, requantizes and all-gathers, int8 and
    scales on the wire. The sums follow the reference's order, so the
    result equals its element for element."""
    n, mine = group.size, group.index
    g = flat.add_(err)                                  # error feedback in
    q, s = gc.quant_blocks(g)
    _residual_(err, g, q, s)                            # residual out
    rows = g.shape[0] // n

    def shard(k: int) -> slice:
        return slice(k * rows, (k + 1) * rows)

    acc = gc.dequant_blocks(q[shard(mine)], s[shard(mine)])
    for hop in range(1, n):
        to, frm = (mine + hop) % n, (mine - hop) % n
        qr, sr = _ring_hop(group, q[shard(to)], s[shard(to)], to, frm)
        _add_dequant_(acc, qr, sr)
        del qr, sr
    del q, s
    # a true division, as the reference's: a divisor held in a tensor
    # never becomes a multiply by its reciprocal
    acc.div_(torch.full((1, 1), float(n), device=acc.device))
    qa, sa = gc.quant_blocks(acc)
    del acc
    for k, (qk, sk) in enumerate(_gather_shards(group, qa, sa)):
        gc.dequant_blocks(qk, sk, out=g[shard(k)])
    return g, err
