"""Shared by the tests of training on a (pod, data, model) mesh
(``test_torch_tp_train.py``, ``test_torch_tp_kinds.py``): the reference's
jitted one-device step on the CPU, and the gates each rank's steps are held
to (``test_torch_tp_train.py``'s docstring states them)."""
import dataclasses
import functools

import jax
import numpy as np

import _torch_dist
from repro.configs import get_config as jax_config
from repro.data import device_put_batch
from repro.launch.mesh import make_debug_mesh
from repro.models import Model as JaxModel
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import TrainSetup as JaxTrainSetup
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM

AXES2, AXES3 = ("data", "model"), ("pod", "data", "model")
F32 = dict(compute_dtype="float32", param_dtype="float32")
# the layer kinds: mamba (the scan on di/2 channels, x_proj's all-reduce
# both ways), RG-LRU with its shared MQA KV head, MoE (EP) with a shared
# expert, MQA with the prefix-LM prefix, and qk-norm
KINDS = ["falcon-mamba-7b", "recurrentgemma-9b", "llama4-maverick-400b-a17b",
         "paligemma-3b", "gemma3-4b"]
PADDED = {"n_heads": 6, "n_kv_heads": 2, "pad_heads_to": 8}
# two stacked periods: ZeRO-1 gives each to one rank at data 2
LAYERS4 = (("n_layers", 4),)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# unmasked tokens of each of the B 4 rows of an uneven loss mask: the DP
# ranks' counts differ (96 against 26 at data 2), and so do those of each
# rank's rows of the two microbatches (64, 32 and 19, 7)
UNEVEN_COUNTS = (64, 32, 19, 7)


def batch_for(arch, seed=1, cfg_kw=(), uneven=False):
    """``SyntheticLM``'s batch; with ``uneven``, a loss mask whose rows keep
    ``UNEVEN_COUNTS`` tokens each, at positions drawn from a seed."""
    cfg = dataclasses.replace(get_config(arch).smoke(), **dict(cfg_kw))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=_torch_dist.S,
                    global_batch=_torch_dist.B, seed=seed, n_prefix=cfg.n_prefix,
                    d_model=cfg.d_model)
    batch = next(SyntheticLM(dc).batches())
    if uneven:
        rng = np.random.default_rng(5)
        mask = np.zeros_like(batch["loss_mask"])
        for row, n in enumerate(UNEVEN_COUNTS):
            mask[row, rng.permutation(_torch_dist.S)[:n]] = 1.0
        batch["loss_mask"] = mask
    return batch


@functools.lru_cache(maxsize=None)
def reference_run(arch, cfg_kw=(), n_steps=2, train_kw=(), uneven=False):
    """The reference's jitted one-device step (with ``train_kw``, e.g. its
    microbatches), ``n_steps`` times from its seeded state (PRNGKey 7) on
    ``batch_for(arch, uneven=uneven)``. Returns the initial state (numpy),
    the batch, and each step's metrics, params and moments."""
    jcfg = dataclasses.replace(jax_config(arch).smoke(), **F32, **dict(cfg_kw))
    mesh = make_debug_mesh(1, 1)
    ts = JaxTrainSetup(JaxModel(jcfg), mesh, JaxTrainConfig(
        **_torch_dist.STEP_CFG, **dict(train_kw)))
    st = ts.init_state(jax.random.PRNGKey(7))
    st0 = np_tree(st)
    batch = batch_for(arch, cfg_kw=cfg_kw, uneven=uneven)
    rows = []
    with jax.set_mesh(mesh):
        step = jax.jit(ts.step_fn())
        for _ in range(n_steps):
            st, m, _ = step(st, device_put_batch(batch, mesh, ts.rules))
            rows.append({"metrics": {k: float(v) for k, v in m.items()},
                         "params": np_tree(st["params"]), "mu": np_tree(st["opt"]["mu"]),
                         "nu": np_tree(st["opt"]["nu"])})
    return st0, batch, rows


def steps_job(arch, cfg_kw=(), train_kw=None, uneven=False):
    st0, batch, _ = reference_run(arch, tuple(cfg_kw),
                                  train_kw=tuple((train_kw or {}).items()),
                                  uneven=uneven)
    return {"kind": "steps", "arch": arch, "cfg_kw": dict(cfg_kw),
            "train_kw": train_kw or {}, "state": st0, "batch": batch}


def paths(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def leaf_rel(want, got):
    w, g = paths(want), paths(got)
    assert w.keys() == g.keys()
    return {k: float(np.abs(w[k].astype(np.float64) - g[k]).max()
                     / max(np.abs(w[k]).max(), 1e-30)) for k in w}


def update_rel(w0, w1, g0, g1):
    p = [paths(t) for t in (w0, w1, g0, g1)]
    return {k: float(np.linalg.norm((p[3][k].astype(np.float64) - p[2][k])
                                    - (p[1][k].astype(np.float64) - p[0][k]))
                     / max(np.linalg.norm(p[1][k].astype(np.float64) - p[0][k]), 1e-30))
            for k in p[0]}


def bit_equal(a, b):
    pa, pb = paths(a), paths(b)
    return pa.keys() == pb.keys() and all(
        pa[k].dtype == pb[k].dtype and pa[k].tobytes() == pb[k].tobytes() for k in pa)


def hold(arch, got, cfg_kw=(), train_kw=(), uneven=False):
    """Each rank's two steps against the reference's (module docstring)."""
    _, _, want = reference_run(arch, tuple(cfg_kw), train_kw=tuple(train_kw),
                               uneven=uneven)
    r0 = got[0]
    for i in range(2):
        w, g = want[i]["metrics"], r0["metrics"][i]
        assert abs(g["loss"] - w["loss"]) / abs(w["loss"]) < 1e-5, (arch, i, w, g)
        assert abs(g["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"]) < 1e-4, (arch, i)
    for part, limit in (("params", 1e-4), ("mu", 5e-4), ("nu", 5e-4)):
        errs = leaf_rel(want[0][part], r0["snapshots"][0][part])
        worst = max(errs, key=errs.get)
        assert errs[worst] < limit, (arch, part, worst, errs[worst])
    upd = update_rel(want[0]["params"], want[1]["params"],
                      r0["snapshots"][0]["params"], r0["snapshots"][1]["params"])
    worst = max(upd, key=upd.get)
    assert upd[worst] < 5e-2, (arch, worst, upd[worst])
    for g in got[1:]:
        for a, b in zip(g["snapshots"], r0["snapshots"]):
            assert bit_equal(a["params"], b["params"])
        assert g["metrics"] == r0["metrics"]


def grad_tree(arch, cfg_kw=()):
    """A whole gradient tree in the reference's layout: normal values."""
    cfg = dataclasses.replace(jax_config(arch).smoke(), **F32, **dict(cfg_kw))
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                        np_tree(JaxModel(cfg).init(jax.random.PRNGKey(0))))


def norm_job(arch, cfg_kw=(), train_kw=None):
    return {"kind": "norm", "arch": arch, "cfg_kw": dict(cfg_kw),
            "train_kw": train_kw or {}, "tree": grad_tree(arch, cfg_kw)}


def whole_norm(arch, cfg_kw=()):
    return float(np.sqrt(sum(np.sum(np.square(a.astype(np.float64)))
                             for a in jax.tree.leaves(grad_tree(arch, cfg_kw)))))
