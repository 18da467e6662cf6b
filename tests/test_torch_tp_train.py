"""Port parity for training on a (pod, data, model) mesh with ``model`` > 1:
the autograd collectives of ``repro_torch/train/sharding.py``'s
``TPContext`` (Megatron's pair, the gathered router logits, the
``fsdp_experts`` gather), the vocab-parallel cross-entropy, the sharded
global norm and ZeRO-1 on TP shards (``optim/optimizer.py``), the TP
branches of ``train/train_step.py``, the checkpoint across mesh shapes and
the launcher's ``--mesh PxDxM``; and the selective scan's
``autograd.Function``. Ranks are gloo processes on the CPU
(``launch.spawn.run_ranks``, rank functions in ``tests/_torch_dist.py``),
the checks of one mesh in one spawn.

Every step is held against the reference's jitted one-device step on the
CPU from the same state (the reference's ``init_state``, converted) and
batch, as the reference's ``tests/distributed_checks.py::
check_sharded_equals_single`` holds its 2x2 step: smoke configs in f32,
B 4, S 64, data seed 1, two steps of which the first has LR 0.

Tolerances:
- loss within 1e-5 relative and grad_norm within 1e-4 relative at both
  steps, and after the first step (LR 0) every param within 1e-4 of its
  leaf's max: the reference's own gates; both moments after it (which hold
  the reduced gradients) within 5e-4 of their leaf's max, the tolerance
  ``test_torch_train.py`` sets for gradients in the stacked scan layout
  (the port on one device already lies 1.1e-4 (mu) and 2.2e-4 (nu) from
  the reference at falcon-mamba's ``x_proj``, and 1.0e-4 at paligemma's
  ``wk``: the frameworks round otherwise);
- the second step's update of each leaf within 5e-2 of the reference's,
  relative in the Frobenius norm (an update left out reads 1): Adam's step
  m/sqrt(v) takes the sign of a near-zero gradient element, which follows
  rounding, so its params are not gated element by element (as in
  ``test_torch_distributed.py``); the port on one device already lies
  1.9e-2 from the reference's update at falcon-mamba's ``x_proj``;
- the ranks' params after each step, and the checkpoint restored at
  another mesh: bit for bit; the compressed ring against the reference's
  ``_pod_reduce`` (under ``jax.vmap``, op by op): element for element;
- the collectives in f64 against one rank: 1e-12 relative; the
  cross-entropy chunk, whose logits are f32 after the softcap as the
  reference's: 1e-6 relative; the sharded global norm against the whole
  tree's f64 norm: 1e-6 relative;
- ``SelectiveScan``'s backward with the whole sequence recomputed against
  autograd through the plain scan: bit for bit; recomputed in chunks of
  the sequence: 1e-6 of each gradient's max |g| (dA sums its time steps in
  another order).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_dist  # noqa: E402
import _torch_tp_ref as R  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import device_put_batch  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import TrainSetup as JaxTrainSetup  # noqa: E402
from repro.train.train_step import _pod_reduce as jax_pod_reduce  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as scan_kernel  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.model import _xent_chunk  # noqa: E402
from repro_torch.optim.grad_compress import QBLOCK  # noqa: E402

# -- the collectives ------------------------------------------------------------

_RNG = np.random.default_rng(21)
COLL = {"x": _RNG.standard_normal((3, 64)), "w1": _RNG.standard_normal((64, 32)) / 8,
        "w2": _RNG.standard_normal((32, 64)) / 6, "router": _RNG.standard_normal((64, 64)) / 8,
        "c": _RNG.standard_normal((3, 64)), "table": _RNG.standard_normal((256, 64)),
        "h": _RNG.standard_normal((2, 5, 64)) / 8,
        "t": _RNG.integers(0, 256, (2, 5)).astype(np.int32),
        "mask": (_RNG.random((2, 5)) > 0.3).astype(np.float32),
        "ws": _RNG.standard_normal((4, 6))}


@pytest.fixture(scope="module")
def at_1x2():
    """The checks of mesh 1x2 in one spawn: the collectives and the
    reference's sharded-equals-single twin (the layer kinds are
    ``test_torch_tp_kinds.py``'s)."""
    jobs = [{"kind": "collectives", **COLL}, R.steps_job("gemma2-27b")]
    return run_ranks(_torch_dist.tp_jobs, 2, (1, 2), R.AXES2, jobs)


@pytest.fixture(scope="module")
def at_2x2(tmp_path_factory):
    """The checks of mesh 2x2 in one spawn: the sharded-equals-single twin,
    llama4 with ``fsdp_experts`` (its step and its global norm), and the
    reshard twin's restore and step (a checkpoint saved at 1x4, where the
    padded heads' global norm is checked too)."""
    d = str(tmp_path_factory.mktemp("reshard"))
    saved = run_ranks(_torch_dist.tp_jobs, 4, (1, 4), R.AXES2, [
        {"kind": "save", "arch": "falcon-mamba-7b", "cfg_kw": {}, "directory": d},
        R.norm_job("arctic-480b", tuple(R.PADDED.items()))])
    fsdp = {"fsdp_experts": True}
    got = run_ranks(_torch_dist.tp_jobs, 4, (2, 2), R.AXES2, [
        R.steps_job("gemma2-27b", R.LAYERS4),
        R.steps_job("llama4-maverick-400b-a17b", train_kw=fsdp),
        R.norm_job("llama4-maverick-400b-a17b", train_kw=fsdp),
        {"kind": "restore", "arch": "falcon-mamba-7b", "cfg_kw": {}, "directory": d,
         "batch": R.batch_for("falcon-mamba-7b")}])
    back = run_ranks(_torch_dist.tp_jobs, 4, (4, 1), R.AXES2, [
        {"kind": "restore", "arch": "falcon-mamba-7b", "cfg_kw": {}, "directory": d}])
    return {"saved": saved, "got": got, "back_4x1": back}


def test_collectives_and_vocab_xent_at_1x2_in_f64(at_1x2):
    """Megatron's pair (column- then row-parallel), the gathered router
    logits, the all-gather whose backward sums over the group, and the
    vocab-parallel cross-entropy chunk with its z-loss term, each rank on
    its shards: values and gradients against one rank on the whole
    arrays."""
    cfg = _torch_dist.smoke_config()
    X, W1, W2, R, T, H, WS = (torch.from_numpy(COLL[k]).requires_grad_()
                              for k in ("x", "w1", "w2", "router", "table", "h", "ws"))
    c = torch.from_numpy(COLL["c"])
    out = torch.tanh(X @ W1) @ W2
    probs = torch.softmax(X @ R, -1)
    nll, z2 = _xent_chunk({"table": T}, H, torch.from_numpy(COLL["t"]),
                          torch.from_numpy(COLL["mask"]), cfg)
    loss = (out * c).sum() + (probs * c).sum() + nll + 1e-4 * z2
    gx, gw1, gw2, gr, gt, gh = torch.autograd.grad(loss, [X, W1, W2, R, T, H])
    for r, res in enumerate(g[0] for g in at_1x2):
        cols, rows = slice(r * 16, (r + 1) * 16), slice(r * 128, (r + 1) * 128)
        np.testing.assert_allclose(res["out"], out.detach().numpy(), rtol=1e-12)
        np.testing.assert_allclose(res["probs"], probs.detach().numpy(), rtol=1e-12)
        np.testing.assert_array_equal(res["whole_ws"], COLL["ws"])
        assert res["nll"] == pytest.approx(float(nll), rel=1e-6)
        assert res["z2"] == pytest.approx(float(z2), rel=1e-6)
        g = res["grads"]
        np.testing.assert_allclose(g[1], gw1.numpy()[:, cols], rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(g[2], gw2.numpy()[cols], rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(g[3], gr.numpy()[:, slice(r * 32, (r + 1) * 32)],
                                   rtol=1e-12, atol=1e-14)
        # each rank's objective weighs the gathered whole by rank + 1: the
        # sum over the group reaches every share
        np.testing.assert_array_equal(g[4], np.full((4, 3), 3.0))
        for got, want in ((g[0], gx.numpy()), (g[5], gt.numpy()[rows]), (g[6], gh.numpy())):
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_sharded_step_equals_single_at_1x2(at_1x2):
    """The twin of ``check_sharded_equals_single`` at 1x2: gemma2-27b smoke,
    heads, MLP and vocab over model, each rank its half of every sharded
    leaf (the embedding's 128 of 256 rows)."""
    got = [g[1] for g in at_1x2]
    R.hold("gemma2-27b", got)
    assert (128, 64) in got[0]["param_shapes"]


def test_sharded_step_equals_single_at_2x2(at_2x2):
    """The twin of ``check_sharded_equals_single`` at 2x2, at 4 layers: two
    rows a DP rank, and ZeRO-1 over data on each TP shard (each of the two
    stacked periods' moments on one DP rank)."""
    got = [g[0] for g in at_2x2["got"]]
    R.hold("gemma2-27b", got, R.LAYERS4)
    for g in got:
        empty = [i for i, s in enumerate(g["share_shapes"]) if s == (0,)]
        assert empty and all(g["param_shapes"][i] != (0,) for i in empty)


def test_fsdp_experts_step_at_2x2(at_2x2):
    """llama4 smoke with ``fsdp_experts`` at 2x2: each rank holds its
    experts (model) and half of their ffn axis (data), gathered over data
    a layer; the step equals the reference's one-device step, and the
    experts' moments stay whole for the rank's share (the reference's
    ZeRO-1 constraint gives way there)."""
    got = [g[1] for g in at_2x2["got"]]
    R.hold("llama4-maverick-400b-a17b", got)
    cfg = get_config("llama4-maverick-400b-a17b").smoke()
    E, M, Fe = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    assert (E // 2, M, Fe // 2) in got[0]["param_shapes"]
    assert (E // 2, M, Fe // 2) in got[0]["share_shapes"]


def test_global_norm_counts_padded_heads_and_fsdp_leaves_once(at_2x2):
    """The global norm of a whole gradient tree from each rank's shard of
    it: 6 heads padded to 8 over 4 ranks that share their KV heads (arctic
    at 1x4), and expert leaves cut over data as well as model (llama4 with
    fsdp_experts at 2x2), equal the whole tree's."""
    cases = [("arctic-480b", tuple(R.PADDED.items()), [g[1] for g in at_2x2["saved"]]),
             ("llama4-maverick-400b-a17b", (), [g[2] for g in at_2x2["got"]])]
    for arch, cfg_kw, got in cases:
        want = R.whole_norm(arch, cfg_kw)
        for g in got:
            assert g == pytest.approx(want, rel=1e-6), arch


def test_reshard_twin(at_2x2):
    """The twin of ``check_reshard_restore``: falcon-mamba smoke saved at
    (1, 4), restored at (4, 1) and (2, 2), the whole state bit for bit; then
    one step at (2, 2) from the restored state against the reference's
    one-device step from the same state (its gates: loss, grad_norm, and
    the params at LR 0)."""
    saved = at_2x2["saved"]
    for s in saved[1:]:
        assert R.bit_equal(s[0], saved[0][0])
    whole = saved[0][0]
    for res in [g[3] for g in at_2x2["got"]] + [g[0] for g in at_2x2["back_4x1"]]:
        assert R.bit_equal(res["whole"], whole)
    jcfg = dataclasses.replace(jax_config("falcon-mamba-7b").smoke(), **R.F32)
    mesh = make_debug_mesh(1, 1)
    ts = JaxTrainSetup(JaxModel(jcfg), mesh, JaxTrainConfig(**_torch_dist.STEP_CFG))
    batch = R.batch_for("falcon-mamba-7b")
    with jax.set_mesh(mesh):
        new, m, _ = jax.jit(ts.step_fn())(jax.tree.map(jnp.asarray, whole),
                                          device_put_batch(batch, mesh, ts.rules))
    for g in at_2x2["got"]:
        got = g[3]
        assert abs(got["metrics"]["loss"] - float(m["loss"])) / float(m["loss"]) < 1e-5
        assert abs(got["metrics"]["grad_norm"] - float(m["grad_norm"])) \
            / float(m["grad_norm"]) < 1e-4
        errs = R.leaf_rel(R.np_tree(new["params"]), got["snapshot"]["params"])
        assert max(errs.values()) < 1e-4


def test_compress_pods_at_2x1x2_equals_the_reference_ring():
    """``compress_pods`` at pod 2, model 2: each rank puts the whole
    gradient tree together and reduces its flat, the same bits on both
    model ranks of a pod; every pod's reduced flat and new residual equal
    the reference's ``_pod_reduce`` on the whole flats, element for element,
    at both steps (the second from the first's residual); the ranks end
    with the same params; and the egress sample, gathered over model from
    the embedding's two halves, equals one device's pack of the same
    reduced first leaf."""
    got = run_ranks(_torch_dist.train_steps, 4, (2, 1, 2), R.AXES3,
                    {"arch": "qwen2-72b"},
                    {"compress_pods": True, "egress": "grads_int8",
                     "egress_blocks": 2})
    for g in got[1:]:
        assert R.bit_equal(g["params"], got[0]["params"])
    err = None
    for i in range(2):
        flats = [got[2 * p]["reduces"][i]["flat"] for p in range(2)]
        errs = [got[2 * p]["reduces"][i]["err"] for p in range(2)]
        for p in range(2):
            assert got[2 * p + 1]["reduces"][i]["flat"].tobytes() == flats[p].tobytes()
        if err is not None:
            assert np.stack(errs).tobytes() == err.tobytes()
        red, err = jax.vmap(lambda f, e: jax_pod_reduce(f, e, 2), axis_name="pod")(
            jnp.asarray(np.stack(flats)), jnp.asarray(np.stack(errs)))
        red, err = np.asarray(red), np.asarray(err)
        for r, g in enumerate(got):
            assert g["reduces"][i]["reduced"].tobytes() == red[r // 2].tobytes(), (i, r)
            assert g["reduces"][i]["new_err"].tobytes() == err[r // 2].tobytes(), (i, r)
    rows = -(-sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        R.np_tree(JaxModel(jax_config("qwen2-72b").smoke()).init(jax.random.PRNGKey(0)))))
        // QBLOCK)
    assert got[0]["reduces"][0]["flat"].shape == (rows + rows % 2, QBLOCK)
    # the first leaf is embed/head (d_model, vocab), cut over model on its
    # columns: its first 2048 reduced values, packed on one device
    from repro_torch.kernels.staging_pack import ops as pack_ops
    for i in range(2):
        first = torch.from_numpy(got[0]["reduces"][i]["reduced"].reshape(-1)[:2048].copy())
        blocks, scales = pack_ops.pack_flat(first, (16, 128), (8, 128), torch.int8)
        e = got[0]["egress"][i]
        assert e["blocks"].tobytes() == blocks.numpy().tobytes()
        assert e["scales"].tobytes() == scales.numpy().tobytes()
        assert all(g["egress"][i] == {} for g in got[1:])


def test_selective_scan_function_backward_equals_plain_autograd(monkeypatch):
    """``SelectiveScan`` with the plain forward in the kernel's place: its
    gradients (each input, with and without the output state's cotangent)
    against autograd through ``ssm_scan_ref``: bit for bit with the whole
    sequence recomputed, within 1e-6 of each gradient's max with the
    sequence recomputed in chunks of 7 (a ragged last chunk)."""
    monkeypatch.setattr(scan_kernel, "ssm_scan", ssm_scan_ref)
    rng = np.random.default_rng(4)
    B, S, di, N = 2, 30, 12, 5

    def inputs():
        return [torch.from_numpy(a).requires_grad_() for a in (
            rng.standard_normal((B, S, di)).astype(np.float32),
            np.abs(rng.standard_normal((B, S, di))).astype(np.float32) * 0.1,
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            -np.abs(rng.standard_normal((di, N))).astype(np.float32),
            rng.standard_normal((B, di, N)).astype(np.float32))]

    for with_state in (False, True):
        ins = inputs()
        dy = torch.from_numpy(rng.standard_normal((B, S, di)).astype(np.float32))
        dh = torch.from_numpy(rng.standard_normal((B, di, N)).astype(np.float32))
        y, h = ssm_scan_ref(*ins)
        want = torch.autograd.grad([y, h] if with_state else [y],
                                   ins, [dy, dh] if with_state else [dy])
        y2, h2 = scan_ops.SelectiveScan.apply(*ins)
        assert torch.equal(y2, y) and torch.equal(h2, h)
        got = torch.autograd.grad([y2, h2] if with_state else [y2],
                                  ins, [dy, dh] if with_state else [dy])
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        chunked = scan_ops.scan_vjp(*[t.detach() for t in ins], dy,
                                    dh if with_state else None, chunk=7)
        for g, w in zip(chunked, want):
            assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())


def test_scan_function_keeps_every_mamba_param_in_the_graph(monkeypatch):
    """falcon-mamba smoke's loss through ``SelectiveScan`` (plain forward in
    the kernel's place, as on the card the kernel) reaches every leaf:
    ``A_log``, ``dt_proj``, ``dt_bias`` and ``x_proj`` reach the loss only
    through the scan; their gradients equal the plain path's."""
    monkeypatch.setattr(scan_kernel, "ssm_scan", ssm_scan_ref)
    cfg = _torch_dist.smoke_config("falcon-mamba-7b")
    model = Model(cfg)
    params = model.init(0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _torch_dist.global_batch(cfg).items()}

    def grads(through_function):
        from repro_torch.models import ssm
        fn = ((lambda *a: scan_ops.SelectiveScan.apply(*a)) if through_function
              else ssm_scan_ref)
        monkeypatch.setattr(ssm, "selective_scan", fn)
        from repro_torch.models.layers import tree_leaves
        from repro_torch.train.train_step import tree_unflatten
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = model.loss_fn(tree_unflatten(params, live), batch)
        return torch.autograd.grad(loss, live)

    for g, w in zip(grads(True), grads(False)):
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())


# -- the launcher -----------------------------------------------------------------


@pytest.mark.parametrize("mesh,extra", [("1x2x2", []), ("2x1x2", ["--compress-pods"])])
def test_train_launcher_on_a_tp_mesh_on_the_cpu(mesh, extra, tmp_path):
    """``python -m repro_torch.launch.train --arch gemma2-27b --smoke --mesh
    <mesh> --intransit --egress grads_int8 --device cpu``: the loss falls,
    SAVIME holds every step's diagnostics, every rank reports, and with
    ``--compress-pods`` the pod wire carries the whole tree's flat rows."""
    from repro_torch.launch.train import main
    out = main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu", "--mesh", mesh,
                *extra, "--intransit", "--egress", "grads_int8", "--steps", "6",
                "--seq", "16", "--batch", "4", "--ckpt-every", "3",
                "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert out["diag"].shape == (6, 2)
    np.testing.assert_allclose(out["diag"][:, 0], losses, rtol=1e-6)
    assert len(out["launches_by_rank"]) == 4 and out["restarts"] == 0
    if extra:
        from repro_torch.optim.grad_compress import error_state
        rows = error_state(Model(get_config("gemma2-27b").smoke()).param_specs(), 2)[0]
        assert out["pod_wire"] == {"bytes": 6 * 2 * (rows // 2) * (QBLOCK + 4)}
    else:
        assert out["pod_wire"] == {"bytes": 0}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003",
                                                          "step_00000006"]
