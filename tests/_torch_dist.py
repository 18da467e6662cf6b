"""Rank functions for the port's multi-process tests (one gloo process a
rank, ``repro_torch.launch.spawn.run_ranks``): importable, and free of jax,
so that each rank starts with torch alone. Each builds its mesh, runs its
part and returns numpy for the test process to hold against the reference.
"""
import dataclasses

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import to_reference_layout
from repro_torch.data import DataConfig, SyntheticLM, device_put_batch
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.train import TrainConfig, TrainSetup
from repro_torch.train import train_step as train_step_mod

B, S = 4, 64
# past warmup at step 1 (step 0's LR is 0), so the second step moves params
STEP_CFG = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, egress="none")


def smoke_config(arch="gemma2-27b", **kw):
    """The smoke config in f32, as the reference's distributed checks take
    it, with ``kw`` replaced."""
    return dataclasses.replace(get_config(arch).smoke(), **{
        "compute_dtype": "float32", "param_dtype": "float32", **kw})


def global_batch(cfg, seed=1, batch=B, seq=S):
    return next(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                       global_batch=batch, seed=seed)).batches())


def mesh_info(shape, axes):
    mesh = Mesh(shape, axes)
    return {"rank": mesh.rank, "coords": mesh.coords,
            "groups": {a: g.ranks for a, g in mesh.groups.items()},
            "dp": mesh.dp.ranks, "dp_index": mesh.dp.index}


def ring(flats, errs):
    """``_pod_reduce`` as pod p of len(flats) (one rank a pod): this pod's
    flat and residual in, (reduced, new residual, wire bytes) out."""
    mesh = Mesh((len(flats), 1, 1), ("pod", "data", "model"))
    p = mesh.coords["pod"]
    train_step_mod.POD_WIRE.update(bytes=0)
    red, new_err = train_step_mod._pod_reduce(
        torch.from_numpy(flats[p].copy()), torch.from_numpy(errs[p].copy()),
        mesh.groups["pod"])
    return red.numpy(), new_err.numpy(), dict(train_step_mod.POD_WIRE)


def tree_allreduce(shape, tree, err):
    """``grad_compress.compressed_pod_allreduce`` on this pod's ``tree``
    (numpy leaves) and residual."""
    from repro_torch.optim import grad_compress
    mesh = Mesh(shape, ("pod", "data", "model"))
    p = mesh.coords["pod"]
    red, new_err = grad_compress.compressed_pod_allreduce(
        {k: torch.from_numpy(v[p].copy()) for k, v in tree.items()},
        torch.from_numpy(err[p].copy()), mesh)
    return {k: v.numpy() for k, v in red.items()}, new_err.numpy()


def train_steps(shape, axes, cfg_kw, train_kw, n_steps=2, seed=7):
    """``n_steps`` of the port's step on this rank of the mesh from the
    seeded state, on this rank's rows of the global batch. Returns each
    step's metrics and params and whole moments (gathered; the last step's
    also at the top level), this rank's moment shares' shapes, and with
    compress_pods the reduce's input and output at each step, and each
    step's egress (rank 0's)."""
    cfg = smoke_config(**cfg_kw)
    mesh = Mesh(shape, axes)
    setup = TrainSetup(Model(cfg), TrainConfig(**{**STEP_CFG, **train_kw}), mesh)
    state = setup.init_state(seed, "cpu")
    batch = device_put_batch(global_batch(cfg), mesh, setup.rules, "cpu",
                             setup.cfg.microbatches)
    reduces = []
    inner = train_step_mod._pod_reduce

    def recorded(flat, err, group):
        rec = {"flat": flat.clone().numpy(), "err": err.clone().numpy()}
        red, new_err = inner(flat, err, group)
        reduces.append({**rec, "reduced": red.clone().numpy(),
                        "new_err": new_err.clone().numpy()})
        return red, new_err

    train_step_mod._pod_reduce = recorded
    try:
        step = setup.step_fn()
        metrics, snapshots, egress = [], [], []
        for _ in range(n_steps):
            state, m, e = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            snapshots.append(whole_snapshot(setup, state))
            egress.append({k: v.numpy() for k, v in e.items()})
    finally:
        train_step_mod._pod_reduce = inner
    return {"metrics": metrics, "coords": mesh.coords, "snapshots": snapshots,
            "egress": egress,
            **snapshots[-1],
            "share_shapes": [tuple(t.shape) for t in tree_leaves(state["opt"]["mu"])],
            "reduces": reduces}


def whole_snapshot(setup, state):
    """The params and whole moments (reference layout, numpy) of a state."""
    whole = setup.whole_state(state)
    return {"params": to_reference_layout(whole["params"]),
            "mu": to_reference_layout(whole["opt"]["mu"]),
            "nu": to_reference_layout(whole["opt"]["nu"])}


def save_after_a_step(shape, axes, cfg_kw, directory):
    """Two steps (the second moves params and moments), then a checkpoint
    at step 2 written by rank 0. Returns the whole state saved."""
    cfg = smoke_config(**cfg_kw)
    mesh = Mesh(shape, axes)
    setup = TrainSetup(Model(cfg), TrainConfig(**STEP_CFG), mesh)
    state = setup.init_state(3, "cpu")
    batch = device_put_batch(global_batch(cfg), mesh, setup.rules, "cpu",
                             setup.cfg.microbatches)
    step = setup.step_fn()
    for _ in range(2):
        state, _, _ = step(state, batch)
    ckpt = CheckpointManager(directory, async_writes=False, layout=setup)
    ckpt.save(state, 2)
    ckpt.wait()
    ckpt.close()
    return to_reference_layout(setup.whole_state(state))


def whole_on_root(shape, cfg_kw, train_kw):
    """Two steps, then the whole state gathered to rank 0 alone (what a
    checkpoint's save takes) and to every rank. Returns both, the first
    None off rank 0."""
    cfg = smoke_config(**cfg_kw)
    mesh = Mesh(shape, ("pod", "data", "model"))
    setup = TrainSetup(Model(cfg), TrainConfig(**{**STEP_CFG, **train_kw}), mesh)
    state = setup.init_state(3, "cpu")
    batch = device_put_batch(global_batch(cfg), mesh, setup.rules, "cpu",
                             setup.cfg.microbatches)
    step = setup.step_fn()
    for _ in range(2):
        state, _, _ = step(state, batch)
    root = setup.whole_state(state, root=True)
    return {"root": None if root is None else to_reference_layout(root),
            "every": to_reference_layout(setup.whole_state(state)),
            "splits": sorted({s.kind for s in setup.zero1.plan})
            if setup.zero1 is not None else []}


def restore(shape, axes, cfg_kw, directory):
    """Restore the checkpoint on this mesh. Returns this rank's moment
    shares, and the whole state gathered back from the shares."""
    cfg = smoke_config(**cfg_kw)
    mesh = Mesh(shape, axes)
    setup = TrainSetup(Model(cfg), TrainConfig(**STEP_CFG), mesh)
    ckpt = CheckpointManager(directory, layout=setup)
    state = ckpt.restore(setup.state_specs(), device="cpu")
    ckpt.close()
    return {"shares": [t.numpy().copy() for t in tree_leaves(state["opt"]["mu"])],
            "whole": to_reference_layout(setup.whole_state(state))}


def supervised(shape, axes, directory, fail_at):
    """8 supervised steps, a checkpoint every 2, a failure injected at the
    steps in ``fail_at`` on every rank. Returns the restarts, the losses and
    the params."""
    cfg = smoke_config(n_layers=4)
    mesh = Mesh(shape, axes)
    setup = TrainSetup(Model(cfg), TrainConfig(**STEP_CFG), mesh)
    state = setup.init_state(5, "cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=B)
    batches = (device_put_batch(b, mesh, setup.rules, "cpu",
                                             setup.cfg.microbatches)
               for b in SyntheticLM(dc).batches())
    ckpt = CheckpointManager(directory, layout=setup)
    sup = Supervisor(setup.step_fn(), ckpt, SupervisorConfig(ckpt_every=2))
    state = sup.run(state, batches, 8, abstract_state=setup.state_specs(),
                    device="cpu", fail_at=set(fail_at))
    ckpt.close()
    return {"restarts": sup.restarts,
            "losses": [m["loss"] for m in sup.metrics_log],
            "params": to_reference_layout(state["params"])}


# -- serving on a (data, model) mesh ------------------------------------------


def serve_jobs(shape, jobs):
    """Each job (a dict: ``arch``, ``cfg_kw``, the reference's ``tree`` as
    numpy, ``prompts`` (B, S), ``n_dec``, ``seq_shard_kv``) served on this
    rank of a (data, model) mesh of ``shape``: this rank's shard of the
    converted params, its rows of the prompts, prefill and ``n_dec`` greedy
    steps on its own tokens. Returns for each job the logits of the
    prefill and each step (rows gathered over DP), the tokens, this rank's
    shard of the converted tree and of its own sharded init (reference
    layout), and the shapes of its caches, from the prefill and from
    ``Model.init_cache``."""
    from repro_torch.convert import params_from_jax
    from repro_torch.train import ServeSetup
    mesh = Mesh(shape, ("data", "model"))
    out = []
    for job in jobs:
        cfg = dataclasses.replace(get_config(job["arch"]).smoke(), **job["cfg_kw"])
        model = Model(cfg)
        B, S = job["prompts"].shape
        setup = ServeSetup(model, mesh, seq_shard_kv=job.get("seq_shard_kv", False),
                           global_batch=B)
        tp = setup.tp
        params = params_from_jax(job["tree"], cfg, "cpu", mesh=mesh,
                                 rules=setup.rules)
        n_seq = tp.seq.size if tp.seq is not None else 1
        max_len = -(-(S + job["n_dec"]) // n_seq) * n_seq
        rows = setup.rows(B)
        logits, tokens = [], []
        with torch.inference_mode():
            run = model.compute_params(params)
            lg, cache = setup.prefill_fn(max_len)(
                run, {"tokens": torch.from_numpy(job["prompts"][rows])})
            cache_shapes = [tuple(t.shape) for t in tree_leaves(cache)]
            for i in range(job["n_dec"] + 1):
                logits.append(lg)
                tok = lg.argmax(-1)[:, None]
                tokens.append(tok)
                if i == job["n_dec"]:
                    break
                pos = torch.full((tok.shape[0],), S + i, dtype=torch.int32)
                lg, cache = setup.decode_fn()(run, cache, {"tokens": tok, "pos": pos})
        logits, tokens = torch.stack(logits, 1), torch.cat(tokens, 1)
        if tp.dp is not None:
            logits, tokens = (tp.gather(t, tp.dp, dim=0) for t in (logits, tokens))
        res = {"logits": logits.numpy(), "tokens": tokens.numpy(),
               "cache_shapes": cache_shapes, "coords": mesh.coords,
               "init_cache_shapes": [tuple(t.shape) for t in tree_leaves(
                   model.init_cache(B, max_len, "cpu", mesh, setup.rules))]}
        if job.get("shards"):
            res["shard"] = to_reference_layout(params)
            res["init"] = to_reference_layout(
                model.init(seed=3, device="cpu", mesh=mesh, rules=setup.rules))
        out.append(res)
    return out


def train_setup_on(shape):
    """Build the (data, model) mesh of ``shape`` and a TrainSetup on it.
    Returns the mesh's shape and the shapes of this rank's params."""
    mesh = Mesh(shape, ("data", "model"))
    setup = TrainSetup(Model(smoke_config()), TrainConfig(egress="none"), mesh)
    params = setup.init_state(0, "cpu")["params"]
    return mesh.shape, [tuple(t.shape) for t in tree_leaves(params)]


# -- training on a (pod, data, model) mesh -------------------------------------


def tp_jobs(shape, axes, jobs):
    """Each job (a dict: its ``kind`` and keywords) run on this rank of one
    mesh of ``shape`` over ``axes``, in order: one spawn for the checks of
    a mesh. Returns each job's result."""
    mesh = Mesh(shape, axes)
    return [TP_JOBS[job["kind"]](mesh, **{k: v for k, v in job.items()
                                          if k != "kind"})
            for job in jobs]


def _tp_steps(mesh, arch, cfg_kw, train_kw, state, batch, n_steps=2):
    """``n_steps`` of the port's step on this rank from the whole state
    ``state`` (the reference's, numpy) on this rank's rows of ``batch``.
    Returns each step's metrics and whole snapshot, this rank's param and
    moment-share shapes, and the egress rank 0 made."""
    from repro_torch.convert import train_state_from_jax
    cfg = smoke_config(arch, **cfg_kw)
    setup = TrainSetup(Model(cfg), TrainConfig(**{**STEP_CFG, **train_kw}), mesh)
    st = setup.local_state(train_state_from_jax(state, cfg, "cpu"))
    rows = device_put_batch(batch, mesh, setup.rules, "cpu", setup.cfg.microbatches)
    step = setup.step_fn()
    metrics, snapshots, egress = [], [], []
    for _ in range(n_steps):
        st, m, e = step(st, rows)
        metrics.append({k: float(v) for k, v in m.items()})
        snapshots.append(whole_snapshot(setup, st))
        egress.append({k: v.numpy() for k, v in e.items()})
    return {"metrics": metrics, "snapshots": snapshots, "egress": egress,
            "param_shapes": [tuple(t.shape) for t in tree_leaves(st["params"])],
            "share_shapes": [tuple(t.shape) for t in tree_leaves(st["opt"]["mu"])]}


def _tp_collectives(mesh, x, w1, w2, router, c, table, h, t, mask, ws):
    """The autograd collectives of ``TPContext`` on this rank's shards of
    whole f64 arrays, and the vocab-parallel chunk of the cross-entropy:
    values and the gradients of this rank's inputs (numpy)."""
    from repro_torch.models.model import _xent_chunk
    from repro_torch.train.sharding import TPContext, _GatherSum, make_rules
    cfg = smoke_config()
    tp = TPContext(mesh, make_rules(mesh, cfg), cfg)
    m, r = tp.m, tp.r

    def cols(a):
        n = a.shape[-1] // m
        return torch.from_numpy(a[..., r * n:(r + 1) * n].copy()).requires_grad_()

    def rows(a):
        n = a.shape[0] // m
        return torch.from_numpy(a[r * n:(r + 1) * n].copy()).requires_grad_()

    X = torch.from_numpy(x).requires_grad_()
    W1, W2, R, T = cols(w1), rows(w2), cols(router), rows(table)
    # column- then row-parallel: Megatron's pair
    out = tp.reduce(torch.tanh(tp.to_model(X) @ W1) @ W2, torch.float64)
    # router-like: the gathered logits, replicated downstream
    probs = torch.softmax(tp.gather(tp.to_model(X) @ R), -1)
    # an all-gather whose backward sums over the group (fsdp_experts')
    WS = cols(ws)
    whole_ws = _GatherSum.apply(WS, tp.model, ws.ndim - 1)
    H = torch.from_numpy(h).requires_grad_()
    nll, z2 = _xent_chunk({"table": T}, H, torch.from_numpy(t),
                          torch.from_numpy(mask), cfg, tp)
    loss = ((out * torch.from_numpy(c)).sum() + (probs * torch.from_numpy(c)).sum()
            + (whole_ws * (r + 1)).sum() + nll + 1e-4 * z2)
    grads = torch.autograd.grad(loss, [X, W1, W2, R, WS, T, H])
    return {"out": out.detach().numpy(), "probs": probs.detach().numpy(),
            "whole_ws": whole_ws.detach().numpy(), "nll": float(nll),
            "z2": float(z2), "grads": [g.numpy() for g in grads]}


def _tp_norm(mesh, arch, cfg_kw, train_kw, tree):
    """``global_norm`` of this rank's shard of the whole gradient tree
    ``tree`` (the reference's layout, numpy) under the setup's plan."""
    from repro_torch.convert import params_from_jax
    from repro_torch.optim.optimizer import global_norm
    cfg = smoke_config(arch, **cfg_kw)
    setup = TrainSetup(Model(cfg), TrainConfig(**{**STEP_CFG, **train_kw}), mesh)
    local = params_from_jax(tree, cfg, "cpu", mesh=mesh, rules=setup.rules)
    return float(global_norm(local, setup.norm))


def _tp_save(mesh, arch, cfg_kw, directory):
    cfg = smoke_config(arch, **cfg_kw)
    setup = TrainSetup(Model(cfg), TrainConfig(**STEP_CFG), mesh)
    state = setup.init_state(9, "cpu")
    ckpt = CheckpointManager(directory, async_writes=False, layout=setup)
    ckpt.save(state, 1)
    ckpt.wait()
    ckpt.close()
    return to_reference_layout(setup.whole_state(state))


def _tp_restore(mesh, arch, cfg_kw, directory, batch=None):
    """Restore the checkpoint on this mesh: the whole state gathered back
    from this rank's shares, and with ``batch`` the metrics and whole
    snapshot of one step from it."""
    cfg = smoke_config(arch, **cfg_kw)
    setup = TrainSetup(Model(cfg), TrainConfig(**STEP_CFG), mesh)
    ckpt = CheckpointManager(directory, layout=setup)
    state = ckpt.restore(setup.state_specs(), device="cpu")
    ckpt.close()
    out = {"whole": to_reference_layout(setup.whole_state(state))}
    if batch is not None:
        state, m, _ = setup.step_fn()(state, device_put_batch(batch, mesh,
                                                              setup.rules, "cpu"))
        out["metrics"] = {k: float(v) for k, v in m.items()}
        out["snapshot"] = whole_snapshot(setup, state)
    return out


TP_JOBS = {"steps": _tp_steps, "collectives": _tp_collectives, "norm": _tp_norm,
           "save": _tp_save, "restore": _tp_restore}


# -- the dry run's collectives against a real run's -----------------------------


def collective_records(shape, axes, jobs):
    """Each job (arch, cfg_kw, lowp) one train step at smoke size (B, S) on
    this rank of a real mesh of ``shape``, under ``record_collectives``:
    the step the dry run counts (``launch.dryrun.build_step``) on real
    tensors. Returns each job's record."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.mesh import record_collectives
    from repro_torch.models.layers import lowp_collectives
    mesh = Mesh(shape, axes)
    out = []
    for job in jobs:
        cfg = smoke_config(job["arch"], **job["cfg_kw"])
        fn, args = build_step(cfg, ShapeConfig("smoke", S, B, "train"), mesh,
                              device="cpu")
        with lowp_collectives(job["lowp"]), record_collectives() as rec:
            fn(*args)
        out.append(rec)
    return out
