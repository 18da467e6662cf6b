"""Port parity for data-parallel training over a (pod, data, model=1) mesh:
``repro_torch/launch/mesh.py``, ``train/sharding.py``, ZeRO-1 in
``optim/optimizer.py``, the mesh branches of ``train/train_step.py``, the
mesh-aware checkpoint and supervisor, and the launcher's ``--mesh``. Ranks
are gloo processes on the CPU (``launch.spawn.run_ranks``, the rank
functions in ``tests/_torch_dist.py``), 2 or 4 of them, at the gemma2-27b
smoke config in f32 (B 4, S 64, as the reference's
``tests/distributed_checks.py``).

Tolerances:
- a DP step against the port's 1x1 step on the same state and batch:
  ``distributed_checks.py``'s gates, loss 1e-5 relative, grad_norm 1e-4
  relative, every param after the reference's step (LR 0) within 1e-4 of
  its leaf's max |p|; the moments after it are held to the same 1e-4 of
  each leaf's max (the DP mean rounds otherwise than one device's sum);
  the second step's update of each leaf within 1e-2 of one device's,
  relative in the Frobenius norm (an update left out reads 1);
- ZeRO-1 against the same mesh without it, the ranks against each other,
  and a checkpoint restored across DP shapes: bit for bit;
- the split dimension of each leaf: the reference's ``_zero1_axes``, and
  the specs' logical axes the reference's, exactly.
"""
import dataclasses
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import _torch_dist  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.layers import is_spec  # noqa: E402
from repro.optim.optimizer import _zero1_axes  # noqa: E402
from repro.train.sharding import make_rules as jax_make_rules  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import to_reference_layout  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.models.transformer import unstack_scan_specs  # noqa: E402
from repro_torch.optim.optimizer import FULL, zero1_plan  # noqa: E402
from repro_torch.train import TrainConfig, TrainSetup  # noqa: E402
from repro_torch.train.sharding import batch_rows, make_rules, shard_batch  # noqa: E402

AXES3 = ("pod", "data", "model")


def _fake_mesh(shape, axes, coords=None):
    """What make_rules and batch_rows read of a mesh (both packages')."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes,
                                 coords=coords or dict.fromkeys(axes, 0))


def _paths(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _rel_err(want, got):
    """{path: max |want - got| / max |want|} over want's leaves."""
    w, g = _paths(want), _paths(got)
    assert w.keys() == g.keys()
    return {k: float(np.abs(w[k].astype(np.float64) - g[k]).max()
                     / max(np.abs(w[k]).max(), 1e-30)) for k in w}


def _update_rel(w0, w1, g0, g1):
    """{path: ||(g1 - g0) - (w1 - w0)|| / ||w1 - w0||}: a step's update of
    each leaf against the wanted one, Frobenius."""
    p = [_paths(t) for t in (w0, w1, g0, g1)]
    out = {}
    for k in p[0]:
        dw = p[1][k].astype(np.float64) - p[0][k]
        dg = p[3][k].astype(np.float64) - p[2][k]
        out[k] = float(np.linalg.norm(dg - dw) / max(np.linalg.norm(dw), 1e-30))
    return out


def _bit_equal(a, b):
    pa, pb = _paths(a), _paths(b)
    return pa.keys() == pb.keys() and all(
        pa[k].dtype == pb[k].dtype and pa[k].tobytes() == pb[k].tobytes() for k in pa)


# -- the mesh and the rules ---------------------------------------------------


def test_mesh_coords_and_groups_at_2x2x1():
    """Ranks row-major over (pod, data, model); each axis's group the ranks
    that differ only there; the DP group pod-major over (pod, data)."""
    got = run_ranks(_torch_dist.mesh_info, 4, (2, 2, 1), AXES3)
    for r, info in enumerate(got):
        p, d = divmod(r, 2)
        assert info["rank"] == r and info["coords"] == {"pod": p, "data": d, "model": 0}
        assert info["groups"]["pod"] == [d, 2 + d]
        assert info["groups"]["data"] == [2 * p, 2 * p + 1]
        assert info["groups"]["model"] == [r]
        assert info["dp"] == [0, 1, 2, 3] and info["dp_index"] == r


def test_meshes_the_port_refuses():
    """A mesh with model > 1 builds, and a TrainSetup on it too, each rank
    holding its half of the sharded leaves (the embedding's 128 of 256
    rows); the production meshes need 256 and 512 ranks, as the
    reference's do; a mesh must match the world."""
    got = run_ranks(_torch_dist.train_setup_on, 2, (1, 2))
    for shape, param_shapes in got:
        assert shape == {"data": 1, "model": 2}
        assert (128, 64) in param_shapes and (256, 64) not in param_shapes
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} devices"):
            mesh_mod.make_production_mesh(multi_pod=multi)
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        mesh_mod.make_debug_mesh(2, 1)
    one = mesh_mod.make_debug_mesh(1, 1, pod=1)
    assert one.shape == {"pod": 1, "data": 1, "model": 1} and one.dp.size == 1
    assert mesh_mod.parse_mesh("2x4x1") == ((2, 4, 1), AXES3)
    with pytest.raises(ValueError):
        mesh_mod.parse_mesh("2x")


@pytest.mark.parametrize("shape,axes,arch,global_batch", [
    ((1, 1), ("data", "model"), "gemma2-27b", 0),
    ((4, 1), ("data", "model"), "qwen2-72b", 0),
    ((2, 2, 1), AXES3, "granite-34b", 0),
    ((2, 2, 1), AXES3, "gemma3-4b", 1),          # batch 1: replicated
])
def test_make_rules_are_the_reference_rules(shape, axes, arch, global_batch):
    for seq_shard_kv in (False, True):
        kw = dict(seq_shard_kv=seq_shard_kv, global_batch=global_batch)
        want = jax_make_rules(_fake_mesh(shape, axes), jax_config(arch), **kw)
        got = make_rules(_fake_mesh(shape, axes), get_config(arch), **kw)
        assert got == want


def test_shard_batch_gives_each_rank_its_rows():
    """Rank (p, d) of a 2x2x1 mesh takes rows [2p + d] of a batch of 4 (of
    8: two rows each), pod-major; a batch the DP ranks do not divide is
    replicated by the rule made for it."""
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3), "mask": torch.arange(8.0)}
    for p in range(2):
        for d in range(2):
            m = _fake_mesh((2, 2, 1), AXES3, {"pod": p, "data": d, "model": 0})
            rows = shard_batch(m, make_rules(m), batch)
            i = 2 * p + d
            assert np.array_equal(rows["tokens"], batch["tokens"][2 * i:2 * i + 2])
            assert torch.equal(rows["mask"], batch["mask"][2 * i:2 * i + 2])
            one = make_rules(m, global_batch=1)
            assert batch_rows(m, one, 1) == slice(0, 1)
    with pytest.raises(ValueError, match="does not split"):
        batch_rows(_fake_mesh((2, 2, 1), AXES3), make_rules(_fake_mesh((2, 2, 1), AXES3)), 6)


# -- ZeRO-1 -------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_carry_the_reference_logical_axes(arch):
    jspecs = jax.tree.leaves(JaxModel(jax_config(arch).smoke()).param_specs(),
                             is_leaf=is_spec)
    specs = tree_leaves(Model(get_config(arch).smoke()).param_specs())
    assert len(specs) == len(jspecs)
    for s, j in zip(specs, jspecs):
        assert s.shape == j.shape and s.axes == tuple(j.logical_axes)


@pytest.mark.parametrize("arch,n_layers,dp", [
    ("gemma2-27b", 4, 2),          # 2 stacked periods: split on `layers`
    ("gemma2-27b", 8, 4),          # 4 periods over 4 ranks
    ("gemma2-27b", 3, 2),          # no stacked entry: nothing splits
    ("recurrentgemma-9b", 6, 2),   # the gates' None axes and the periods
])
def test_zero1_splits_the_dimension_the_reference_picks(arch, n_layers, dp):
    """Each port leaf's split against ``_zero1_axes`` on the reference's
    (stacked) spec: its dim, minus the periods axis in a per-period leaf,
    or the period's owner where the reference splits the periods axis."""
    cfg = dataclasses.replace(get_config(arch).smoke(), n_layers=n_layers)
    jcfg = dataclasses.replace(jax_config(arch).smoke(), n_layers=n_layers)
    specs = Model(cfg).param_specs()
    plan = zero1_plan(specs, unstack_scan_specs(specs, cfg), dp)
    jspecs = JaxModel(jcfg).param_specs()
    dp_axes = ("data",)
    n_split = 0
    for path, jspec in jax.tree_util.tree_leaves_with_path(jspecs, is_leaf=is_spec):
        keys = [p.key for p in path]
        node = plan
        for k in keys[:2] if keys[0] == "scan" else keys:
            node = node[k]
        zaxes = _zero1_axes(jspec.logical_axes, jspec.shape, dp_axes, dp)
        d = zaxes.index("__zero1__") if "__zero1__" in zaxes else None
        if keys[0] == "scan":
            periods = node
            for k in keys[2:]:
                periods = [p[k] for p in periods]
            n = len(periods)
            for i, split in enumerate(periods):
                want = (FULL if d is None else
                        ("owner", i // (n // dp)) if d == 0 else ("dim", d - 1))
                got = split if split == FULL else (split.kind, split.arg)
                assert got == want, (keys, i)
        else:
            want = FULL if d is None else ("dim", d)
            assert (node if node == FULL else (node.kind, node.arg)) == want, keys
        n_split += d is not None
    assert (n_split > 0) == (n_layers != 3)


@functools.lru_cache(maxsize=None)
def _dp_run(shape, microbatches=1, zero1=True, n_layers=4):
    from repro_torch.optim import AdamWConfig
    axes = AXES3 if len(shape) == 3 else ("data", "model")
    return run_ranks(_torch_dist.train_steps, int(np.prod(shape)), shape, axes,
                     {"n_layers": n_layers},
                     {"microbatches": microbatches, "opt": AdamWConfig(zero1=zero1)})


@functools.lru_cache(maxsize=None)
def _one_device_run(microbatches=1, n_layers=4):
    cfg = _torch_dist.smoke_config(n_layers=n_layers)
    setup = TrainSetup(Model(cfg), TrainConfig(**_torch_dist.STEP_CFG,
                                               microbatches=microbatches))
    state = setup.init_state(7, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _torch_dist.global_batch(cfg).items()}
    step, metrics, snapshots = setup.step_fn(), [], []
    for _ in range(2):
        state, m, _ = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        snapshots.append(_torch_dist.whole_snapshot(setup, state))
    return metrics, snapshots


@pytest.mark.parametrize("shape,microbatches", [
    ((1, 2, 1), 1), ((2, 2, 1), 1), ((1, 2, 1), 2)])
def test_dp_step_matches_one_device(shape, microbatches):
    """Two steps of the port's DP step, each rank on its rows, against its
    1x1 step on the whole batch: the reference's gates (loss, grad_norm at
    both steps; params after the first, at LR 0, as the reference's check
    takes them), the moments after the first step (which hold the reduced
    gradients) to the params' gate, the second step's update of each leaf
    within 1e-2 (Frobenius) of one device's, and every rank's params the
    same bits after each step. The second step's params are not gated
    element by element: Adam's step m/sqrt(v) takes the sign of a near-zero
    gradient element, which follows rounding (on the card they lay 6.0e-4
    of a leaf's max apart); ZeRO-1 against the unsplit update on the same
    gradients is bit for bit (below)."""
    got = _dp_run(shape, microbatches)
    metrics, want = _one_device_run(microbatches)
    for i in range(2):
        m1, m2 = metrics[i], got[0]["metrics"][i]
        assert abs(m2["loss"] - m1["loss"]) / abs(m1["loss"]) < 1e-5, (i, m1, m2)
        assert abs(m2["grad_norm"] - m1["grad_norm"]) / abs(m1["grad_norm"]) < 1e-4
    for part in ("params", "mu", "nu"):
        errs = _rel_err(want[0][part], got[0]["snapshots"][0][part])
        assert max(errs.values()) < 1e-4, (part, max(errs.items(), key=lambda kv: kv[1]))
    assert max(_rel_err(want[1]["params"], _torch_dist_params0()).values()) > 1e-3
    snaps = got[0]["snapshots"]
    upd = _update_rel(want[0]["params"], want[1]["params"], snaps[0]["params"],
                      snaps[1]["params"])
    assert max(upd.values()) < 1e-2, max(upd.items(), key=lambda kv: kv[1])
    for g in got[1:]:
        for a, b in zip(g["snapshots"], got[0]["snapshots"]):
            assert _bit_equal(a["params"], b["params"])
        assert g["metrics"] == got[0]["metrics"]


# the DP repair cases: (arch, microbatches), each with the uneven loss mask
DP_REPAIR = [("gemma2-27b", 1), ("gemma2-27b", 2),
             ("llama4-maverick-400b-a17b", 1), ("llama4-maverick-400b-a17b", 2)]


@pytest.fixture(scope="module")
def dp_repair_at_1x2x1():
    """Every DP repair case in one spawn of two ranks at (pod 1, data 2,
    model 1)."""
    import _torch_tp_ref as R
    jobs = [R.steps_job(a, train_kw={"microbatches": n}, uneven=True)
            for a, n in DP_REPAIR]
    return run_ranks(_torch_dist.tp_jobs, 2, (1, 2, 1), AXES3, jobs)


@pytest.mark.parametrize("arch,microbatches", DP_REPAIR)
def test_dp_masked_mean_and_microbatch_rows_match_the_reference(
        arch, microbatches, dp_repair_at_1x2x1):
    """DP at data 2 with a loss mask whose unmasked counts differ between
    the ranks and between the microbatches, against the reference's jitted
    one-device step with the same microbatches, under its gates (loss 1e-5,
    grad norm 1e-4, params at LR 0 1e-4; ``_torch_tp_ref.hold``). The
    loss is the global (micro)batch's masked mean, not the mean of each
    rank's; with microbatches a rank's rows are its share of each global
    microbatch (rows 0, 1 make microbatch 0, not rows 0, 2), which the
    masked mean and llama4's load-balance term both see."""
    import _torch_tp_ref as R
    got = [g[DP_REPAIR.index((arch, microbatches))] for g in dp_repair_at_1x2x1]
    R.hold(arch, got, train_kw=(("microbatches", microbatches),), uneven=True)


def test_microbatch_rows_are_each_ranks_share_of_each_microbatch():
    """At data 2 and 2 microbatches of a batch of 8, rank 1 takes rows 2, 3
    of microbatch 0 (rows 0-3) and 6, 7 of microbatch 1; one microbatch
    (or one DP rank) keeps the contiguous slice."""
    for d, want in ((0, [0, 1, 4, 5]), (1, [2, 3, 6, 7])):
        m = _fake_mesh((1, 2, 1), AXES3, {"pod": 0, "data": d, "model": 0})
        assert batch_rows(m, make_rules(m), 8, 2) == want
        assert batch_rows(m, make_rules(m), 8) == slice(4 * d, 4 * d + 4)
    one = _fake_mesh((1, 1, 2), AXES3)
    assert batch_rows(one, make_rules(one), 8, 2) == slice(0, 8)


@functools.lru_cache(maxsize=None)
def _torch_dist_params0():
    cfg = _torch_dist.smoke_config(n_layers=4)
    return to_reference_layout(Model(cfg).init(7, torch.device("cpu")))


def test_zero1_moments_gather_to_the_unsplit_ones():
    """At data 2 the two periods' moments live one on each rank (the shares'
    shapes), and gathered they equal, bit for bit, the moments of the same
    mesh without ZeRO-1; so do the params."""
    split, whole = _dp_run((1, 2, 1)), _dp_run((1, 2, 1), zero1=False)
    for r in range(2):
        assert _bit_equal(split[r]["params"], whole[r]["params"])
        assert _bit_equal(split[r]["mu"], whole[r]["mu"])
        assert _bit_equal(split[r]["nu"], whole[r]["nu"])
    full = whole[0]["share_shapes"]
    for r in range(2):
        shares = split[r]["share_shapes"]
        empty = [i for i, s in enumerate(shares) if s == (0,)]
        assert empty and all(full[i] != (0,) for i in empty)
        assert sum(s != f for s, f in zip(shares, full)) == len(empty)
    assert split[0]["share_shapes"] != split[1]["share_shapes"]


# -- checkpoint and supervisor ----------------------------------------------------


def test_checkpoint_saved_at_data_4_restores_at_data_2_and_1(tmp_path):
    """Saved after two steps at data 4 (8 layers: 4 periods, one a rank),
    restored at data 2 (two periods a rank) and on one device: the whole
    state equal bit for bit, and at data 2 each rank's moment shares the
    slices of the saved moments it owns."""
    cfg_kw = {"n_layers": 8}
    saved = run_ranks(_torch_dist.save_after_a_step, 4, (4, 1), ("data", "model"),
                      cfg_kw, str(tmp_path))
    for s in saved[1:]:
        assert _bit_equal(s, saved[0])
    saved = saved[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002"]
    back = run_ranks(_torch_dist.restore, 2, (2, 1), ("data", "model"), cfg_kw,
                     str(tmp_path))
    for b in back:
        assert _bit_equal(b["whole"], saved)
    stacked = list(_paths(saved["opt"]["mu"]["scan"]).values())
    n_other = len(_paths(saved["opt"]["mu"])) - len(stacked)
    for r, b in enumerate(back):
        owned = [x.tobytes() for x in b["shares"] if x.shape != (0,)]
        assert len(owned) == n_other + 2 * len(stacked)
        for a in stacked:
            assert a.shape[0] == 4
            assert a[2 * r].tobytes() in owned and a[2 * r + 1].tobytes() in owned
    setup = TrainSetup(Model(_torch_dist.smoke_config(**cfg_kw)),
                       TrainConfig(**_torch_dist.STEP_CFG))
    one = CheckpointManager(str(tmp_path)).restore(setup.state_specs(), device="cpu")
    assert _bit_equal(to_reference_layout(one), saved)


@pytest.mark.parametrize("shape,arch,n_layers,compress,splits", [
    ((1, 2, 1), "recurrentgemma-9b", 6, False, ["dim", "full", "owner"]),
    ((2, 1, 1), "gemma2-27b", 4, True, ["full", "owner"]),
    ((2, 2, 1), "gemma2-27b", 4, True, ["full"]),
])
def test_whole_state_for_a_checkpoint_reaches_rank_0_alone(shape, arch, n_layers,
                                                           compress, splits):
    """What a checkpoint's save gathers: on rank 0 the whole state, bit for
    bit what every rank gathers (moment shares split on a dimension and
    periods owned by rank 1, each pod's residual), and None on every other
    rank."""
    got = run_ranks(_torch_dist.whole_on_root, int(np.prod(shape)), shape,
                    {"arch": arch, "n_layers": n_layers}, {"compress_pods": compress})
    assert got[0]["splits"] == splits
    assert _bit_equal(got[0]["root"], got[0]["every"])
    assert ("err" in got[0]["root"]) == compress
    for g in got[1:]:
        assert g["root"] is None
        assert _bit_equal(g["every"], got[0]["every"])


def test_supervisor_fails_and_restores_on_every_rank_at_the_same_step(tmp_path):
    """A failure injected at step 5 on both ranks of data 2: each restores
    the step-4 checkpoint rank 0 wrote, once, and runs step 5 again (8 steps,
    9 logged); the ranks end with the same params and losses."""
    got = run_ranks(_torch_dist.supervised, 2, (2, 1), ("data", "model"),
                    str(tmp_path), [5])
    for g in got:
        assert g["restarts"] == 1 and len(g["losses"]) == 9
        assert np.isfinite(g["losses"]).all()
    assert got[0]["losses"] == got[1]["losses"]
    assert _bit_equal(got[0]["params"], got[1]["params"])


# -- the launcher ---------------------------------------------------------------


def test_train_launcher_at_2x2x1_with_compress_pods_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch gemma2-27b --smoke --mesh
    2x2x1 --compress-pods --intransit --egress grads_int8 --device cpu``:
    the loss falls, SAVIME holds every step's diagnostics (rank 0 stages),
    every rank reports, and the cross-pod wire carries int8 blocks and
    their scales, byte for byte as many as the ring sends."""
    from repro_torch.launch.train import main
    out = main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu", "--mesh",
                "2x2x1", "--compress-pods", "--intransit", "--egress",
                "grads_int8", "--steps", "6", "--seq", "16", "--batch", "4",
                "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert out["diag"].shape == (6, 2)
    np.testing.assert_allclose(out["diag"][:, 0], losses, rtol=1e-6)
    assert len(out["launches_by_rank"]) == 4 and out["restarts"] == 0
    # rank 0's cross-pod wire: each step, one hop of the reduce-scatter and
    # the all-gather's other shard, int8 and a 4 B scale a block
    from repro_torch.optim.grad_compress import QBLOCK, error_state
    rows = error_state(Model(get_config("gemma2-27b").smoke()).param_specs(), 2)[0]
    assert out["pod_wire"] == {"bytes": 6 * 2 * (rows // 2) * (QBLOCK + 4)}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003",
                                                          "step_00000006"]


def test_train_launcher_refuses_the_production_meshes_on_one_process():
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="need 256 devices"):
        main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu", "--mesh", "single"])
