"""Port parity for the training path: repro_torch's loss, gradients, LR
schedule, AdamW, train step, egress and data against the reference's on the
same inputs; the flash-attention autograd.Function against plain autograd;
block remat; and the two CPU entry points (``repro_torch.launch.train`` and
``examples/torch_train_with_intransit.py``).

Params come from the reference's ``init`` through ``params_from_jax`` /
``train_state_from_jax``; batches from numpy seeds. Smoke configs (window
32, 48-token sequences, so the window binds): 3 layers use the `rem`
layout, 4 the stacked `scan` layout.

Tolerances (each max |err| over a leaf against that leaf's max |g|):
- f32, 3 layers: loss 2e-5 relative, grads 1e-4.
- f32, 4 layers: loss 2e-5, grads 5e-4. The scan layout's seeded weights
  carry the reference's fan-in quirk (std 1/sqrt(2) ~ 0.7, ROADMAP caveats),
  which amplifies rounding: moving every param of the *reference* by one ulp
  moves its own gradients by 7.0e-5 of max |g| (jax 0.9.0, CPU), so two
  frameworks that round each op differently land 1.5e-4 apart.
- bf16 compute, 3 layers: loss 1e-3, grads 5e-2 (the two frameworks round
  to bf16 at different points, e.g. the reference's attention rounds P to
  bf16 before P V; measured 1.6e-4 and 2.7e-2).
- AdamW from identical grads and state: 1e-6 relative (f32 elementwise
  ops; XLA and torch may fuse them differently).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.data import device_put_batch  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.optim import schedule as jax_schedule  # noqa: E402
from repro.optim.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim.optimizer import make_optimizer  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import TrainSetup as JaxTrainSetup  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (params_from_jax, to_reference_layout,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.data import DataConfig, SyntheticLM, batch_to_device  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_update, constant,  # noqa: E402
                               decay_mask, warmup_cosine)
from repro_torch.train import TrainConfig, TrainSetup  # noqa: E402
from repro_torch.train.train_step import tree_unflatten  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
B, S = 2, 48
CHUNK = 20          # xent chunk: 48 = 2 * 20 + 8, so the padding runs


def _configs(n_layers, compute_dtype="float32"):
    kw = dict(n_layers=n_layers, compute_dtype=compute_dtype)
    return (dataclasses.replace(jax_config("gemma2-27b").smoke(), **kw),
            dataclasses.replace(get_config("gemma2-27b").smoke(), **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=5, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (batch, seq + 1)).astype(np.int32)
    mask = (rng.random((batch, seq)) > 0.2).astype(np.float32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "loss_mask": mask}


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _leaf_errors(ref_tree, port_tree):
    """{path: max|ref - port| / max|ref|} over the reference's leaves;
    ``port_tree`` in the reference's layout (numpy)."""
    out = {}
    for path, a in jax.tree_util.tree_leaves_with_path(ref_tree):
        b = port_tree
        for p in path:
            b = b[p.key]
        a = np.asarray(a, np.float64)
        assert b.shape == a.shape, path
        out["/".join(str(p.key) for p in path)] = \
            float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
    return out


def _port_value_and_grad(model, params, batch, chunk=CHUNK):
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = model.loss_fn(tree_unflatten(params, live), batch,
                                  xent_chunk=chunk)
    grads = torch.autograd.grad(loss, live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, list(grads)))


# -- loss and gradients -------------------------------------------------------


@pytest.mark.parametrize("n_layers,compute_dtype,loss_rtol,grad_tol", [
    (3, "float32", 2e-5, 1e-4), (4, "float32", 2e-5, 5e-4),
    (3, "bfloat16", 1e-3, 5e-2)])
def test_loss_and_grads_match_reference(n_layers, compute_dtype, loss_rtol,
                                        grad_tol):
    jc, tc = _configs(n_layers, compute_dtype)
    jm, tm = JaxModel(jc), Model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    b = _batch()
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, bb: jm.loss_fn(p, bb, {}, xent_chunk=CHUNK), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tp = params_from_jax(_np_tree(jp), tc, CPU)
    tl, tmet, tg = _port_value_and_grad(tm, tp, _torch_batch(b))
    assert tl.dtype == torch.float32 and sorted(tmet) == sorted(jmet)
    np.testing.assert_allclose(float(tl), float(jl), rtol=loss_rtol)
    for k in ("nll", "z2"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=loss_rtol)
    assert float(tmet["moe_lb"]) == float(tmet["moe_z"]) == 0.0
    errs = _leaf_errors(_np_tree(jg), to_reference_layout(tg))
    assert len(errs) == len(tree_leaves(jax.tree.map(lambda x: 0, jp)))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= grad_tol, (worst, errs[worst])


def test_loss_without_mask_and_prefix_raises():
    """An all-zero mask divides by the floor 1, not by 0; prefix embeddings
    for a config without ``n_prefix`` (gemma2) raise, as the reference fails
    there on the shapes (tests/test_torch_archs.py holds the prefix-LM loss
    of paligemma against the reference)."""
    _, tc = _configs(3)
    tm = Model(tc)
    p = tm.init(seed=0, device=CPU)
    b = _torch_batch(_batch())
    b["loss_mask"] = torch.zeros_like(b["loss_mask"])
    loss, m = tm.loss_fn(p, b)
    assert float(loss) == float(m["nll"]) == float(m["z2"]) == 0.0
    with pytest.raises(ValueError, match="n_prefix"):
        tm.loss_fn(p, {**b, "prefix_embed": torch.zeros(B, 4, 64)})


def test_remat_and_the_flash_function_in_a_train_step(monkeypatch):
    """The card's route on the CPU: attention through the kernel's
    autograd.Function, the plain forward put in for the launch. With
    remat="full" (torch.utils.checkpoint around each block) the launch runs
    twice a layer a step, forward and in the backward's recompute, and the
    backward launches none; with "none" once. Loss and gradients equal plain
    autograd through the plain attention (the loss bit for bit, grads within
    1e-6 of max |g|: dk and dv sum a kv row's query rows in another order)."""
    launches = []

    def plain_launch(q, k, v, **kw):
        launches.append(q.shape)
        return fa_ops.gqa_attention_ref(q, k, v, **kw)

    def through_function(q, k, v, *, scale, softcap, causal, window, prefix):
        return fa_ops.FlashAttention.apply(q, k, v, scale, softcap, causal,
                                           window, prefix)

    monkeypatch.setattr(fa_kernel, "flash_attention", plain_launch)
    _, tc = _configs(4)
    p = Model(tc).init(seed=1, device=CPU)
    plain_loss, _, plain_g = _port_value_and_grad(Model(tc), p,
                                                  _torch_batch(_batch()))
    monkeypatch.setattr(attention_mod, "gqa_attention", through_function)
    for remat, want_launches in (("none", 4), ("full", 8)):
        tm = Model(dataclasses.replace(tc, remat=remat))
        launches.clear()
        loss, _, g = _port_value_and_grad(tm, p, _torch_batch(_batch()))
        assert len(launches) == want_launches, remat
        assert torch.equal(loss, plain_loss)
        errs = _leaf_errors(to_reference_layout(plain_g), to_reference_layout(g))
        assert max(errs.values()) <= 1e-6, remat


# -- the attention Function -------------------------------------------------


@pytest.mark.parametrize("dtype,case", [
    (torch.float32, dict(Hq=4, Hkv=2, window=0, cap=0.0, causal=True)),
    (torch.float32, dict(Hq=4, Hkv=1, window=7, cap=50.0, causal=True)),
    (torch.float32, dict(Hq=2, Hkv=2, window=0, cap=30.0, causal=False)),
    (torch.bfloat16, dict(Hq=4, Hkv=2, window=7, cap=50.0, causal=True)),
])
def test_flash_function_grads_equal_plain_autograd(monkeypatch, dtype, case):
    """The autograd.Function the card runs, on the CPU with the plain forward
    put in for the launch: its forward is the launch's output, and its
    backward (the plain version recomputed one chunk of rows at a time)
    equals plain autograd through the whole plain version. Rows are split
    into chunks of 3 so that a kv row's query rows fall in different
    chunks. f32: 1e-6 relative to max |g| (the same ops; dk and dv sum the
    groups in f32 there, in the input dtype in plain autograd); bf16: one
    bf16 step, 2**-8 of max |g|."""
    launches = []

    def plain_launch(q, k, v, **kw):
        launches.append(q.shape)
        return fa_ops.gqa_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(fa_kernel, "flash_attention", plain_launch)
    monkeypatch.setattr(fa_ref, "_MAX_SCORE_ELEMS", 3 * 24 * 24)
    rng = np.random.default_rng(3)
    Bq, Sq, D = 2, 24, 16

    def mk(H):
        return torch.from_numpy(rng.standard_normal((Bq, Sq, H, D)).astype(
            np.float32)).to(dtype)

    q, k, v = mk(case["Hq"]), mk(case["Hkv"]), mk(case["Hkv"])
    do = mk(case["Hq"])
    kw = dict(scale=0.3, softcap=case["cap"], causal=case["causal"],
              window=case["window"])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa_ops.FlashAttention.apply(*leaves, kw["scale"], kw["softcap"],
                                    kw["causal"], kw["window"])
    got = torch.autograd.grad(o, leaves, do)
    assert len(launches) == 1 and o.dtype == dtype
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    o_p = fa_ops.gqa_attention_ref(*plain, **kw)
    want = torch.autograd.grad(o_p, plain, do)
    assert torch.equal(o, o_p)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert err <= tol, (name, err)
        assert float(g.float().abs().max()) > 0, name


# -- schedule and optimizer -----------------------------------------------


def test_warmup_cosine_matches_reference():
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=50)
    for step in (0, 1, 9, 10, 30, 50, 51, 1000):
        want = float(jax_schedule.warmup_cosine(step, **kw))
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
    assert float(warmup_cosine(0, **kw)) == 0.0
    assert float(constant(7, peak_lr=0.5)) == float(
        jax_schedule.constant(7, peak_lr=0.5)) == 0.5


def _random_like(tree, rng, positive=False):
    def one(a):
        x = rng.standard_normal(np.shape(a)).astype(np.float32)
        return np.abs(x) * 1e-3 if positive else x
    return jax.tree.map(one, tree)


@pytest.mark.parametrize("n_layers", [3, 4])
def test_adamw_update_matches_reference(n_layers):
    """One update from identical grads, moments and params (all random, so
    the norm scales are nonzero and their decay shows). The reference decays
    a leaf when *its* leaf has ndim > 1: a norm scale is decayed in the
    stacked `scan` layout (4 layers) and not in `rem` (3)."""
    jc, tc = _configs(n_layers)
    jm, tm = JaxModel(jc), Model(tc)
    rng = np.random.default_rng(n_layers)
    params = _random_like(_np_tree(jm.init(jax.random.PRNGKey(0))), rng)
    grads = jax.tree.map(lambda a: a * 0.3, _random_like(params, rng))
    mu = jax.tree.map(lambda a: a * 1e-2, _random_like(params, rng))
    nu = _random_like(params, rng, positive=True)
    lr = 1e-2
    init, update = make_optimizer(jm.param_specs(), JaxAdamWConfig())
    jstate = {"mu": mu, "nu": nu, "count": jnp.int32(2)}
    jp2, js2, jstats = jax.jit(update)(grads, jstate, params, jnp.float32(lr))

    conv = functools.partial(params_from_jax, cfg=tc, device=CPU)
    tparams, tgrads = conv(params), conv(grads)
    tstate = {"mu": conv(mu), "nu": conv(nu),
              "count": torch.tensor(2, dtype=torch.int32)}
    decay = decay_mask(tm.param_specs(), tparams)
    if n_layers == 4:
        assert decay["scan"]["0:local"][1]["ln1"] is True
        assert not tparams["rem"]
    else:
        assert decay["rem"]["0:local"]["ln1"] is False
    assert decay["embed"]["table"] is True and decay["final_ln"] is False
    tp2, ts2, tstats = adamw_update(tgrads, tstate, tparams,
                                    torch.tensor(lr, dtype=torch.float32),
                                    AdamWConfig(), decay)
    assert int(ts2["count"]) == 3 and ts2["count"].dtype == torch.int32
    for k in ("grad_norm", "clip_scale"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-6)
    assert float(jstats["clip_scale"]) < 1.0       # the clip binds
    for name, ref_tree, port_tree in (("params", jp2, tp2),
                                      ("mu", js2["mu"], ts2["mu"]),
                                      ("nu", js2["nu"], ts2["nu"])):
        errs = _leaf_errors(_np_tree(ref_tree), to_reference_layout(port_tree))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-6, (name, worst, errs[worst])


# -- the train step -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_step(microbatches):
    """The reference's jitted step from a state with step 3 (warmup 2, so the
    LR is past warmup and nonzero), random moments, on a fixed batch."""
    jc, _ = _configs(3)
    jm = JaxModel(jc)
    mesh = make_debug_mesh(1, 1)
    ts = JaxTrainSetup(jm, mesh, JaxTrainConfig(
        peak_lr=1e-2, warmup_steps=2, total_steps=10, egress="grads_int8",
        egress_blocks=8, xent_chunk=CHUNK, microbatches=microbatches))
    st = _np_tree(ts.init_state(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(9)
    st["opt"]["mu"] = jax.tree.map(lambda a: a * 1e-3,
                                   _random_like(st["opt"]["mu"], rng))
    st["opt"]["nu"] = _random_like(st["opt"]["nu"], rng, positive=True)
    st["opt"]["count"] = np.int32(3)
    st["step"] = np.int32(3)
    b = _batch(seed=4, batch=4)
    with jax.set_mesh(mesh):
        new, metrics, egress = jax.jit(ts.step_fn())(
            jax.tree.map(jnp.asarray, st), device_put_batch(b, mesh, ts.rules))
    return st, b, _np_tree(new), _np_tree(metrics), _np_tree(egress)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("egress", ["none", "diag", "grads_int8"])
def test_train_step_matches_reference(microbatches, egress):
    """One step from the same state (step 3, count 3, nonzero moments) and
    batch: loss, grad_norm, lr, new params, mu, nu, count and step, and the
    egress. The blocks of grads_int8 quantize gradients that differ from the
    reference's by rounding, so a value on a rounding boundary may land one
    int8 step over; byte equality on the *same* gradients is
    ``test_egress_packs_the_first_leaf_byte_for_byte``."""
    st, b, new, metrics, ref_egress = _reference_step(microbatches)
    _, tc = _configs(3)
    ts = TrainSetup(Model(tc), TrainConfig(
        peak_lr=1e-2, warmup_steps=2, total_steps=10, egress=egress,
        egress_blocks=8, xent_chunk=CHUNK, microbatches=microbatches))
    state = train_state_from_jax(st, tc, CPU)
    new_t, m, e = ts.step_fn()(state, batch_to_device(b, "cpu"))
    assert int(new_t["step"]) == 4 and int(new_t["opt"]["count"]) == 4
    for k in ("loss", "nll", "z2", "lr"):
        np.testing.assert_allclose(float(m[k]), float(metrics[k]), rtol=2e-5)
    for k in ("grad_norm", "clip_scale"):
        np.testing.assert_allclose(float(m[k]), float(metrics[k]), rtol=1e-4)
    got = to_reference_layout(new_t)
    for part in ("params", "mu", "nu"):
        ref_tree = new["params"] if part == "params" else new["opt"][part]
        port_tree = got["params"] if part == "params" else got["opt"][part]
        errs = _leaf_errors(ref_tree, port_tree)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-4, (part, worst, errs[worst])
    want_keys = {"none": set(), "diag": {"diag"},
                 "grads_int8": {"diag", "blocks", "scales"}}[egress]
    assert set(e) == want_keys
    if "diag" in e:
        assert e["diag"].dtype == torch.float32 and e["diag"].shape == (2,)
        np.testing.assert_allclose(e["diag"].numpy(), ref_egress["diag"], rtol=1e-4)
    if "blocks" in e:
        assert e["blocks"].dtype == torch.int8 and e["blocks"].shape == (8, 1024)
        np.testing.assert_allclose(e["scales"].numpy(), ref_egress["scales"],
                                   rtol=1e-4)
        diff = np.abs(e["blocks"].numpy().astype(np.int32)
                      - ref_egress["blocks"].astype(np.int32))
        assert diff.max() <= 1 and diff.mean() < 1e-2


def test_egress_packs_the_first_leaf_byte_for_byte():
    """The same gradients (the reference's, converted) through both egress
    functions: the first leaf in the reference's order is embed/table, and
    blocks and scales are equal byte for byte. These gradients have a normal
    amax in every block; only where amax/127 underflows do the two zero-scale
    rules differ (ROADMAP, reference caveats)."""
    for n_layers in (3, 4):
        jc, tc = _configs(n_layers)
        jm = JaxModel(jc)
        jts = JaxTrainSetup(jm, make_debug_mesh(1, 1), JaxTrainConfig(
            egress="grads_int8", egress_blocks=20))
        grads = _random_like(_np_tree(jm.init(jax.random.PRNGKey(0))),
                             np.random.default_rng(1))
        loss, gnorm = jnp.float32(2.5), jnp.float32(0.7)
        want = _np_tree(jts._egress(jax.tree.map(jnp.asarray, grads), loss, gnorm))
        ts = TrainSetup(Model(tc), TrainConfig(egress="grads_int8",
                                               egress_blocks=20))
        got = ts._egress(params_from_jax(grads, tc, CPU), torch.tensor(2.5),
                         torch.tensor(0.7))
        assert np.abs(want["blocks"]).max() == 127
        assert got["blocks"].numpy().tobytes() == want["blocks"].tobytes()
        assert got["scales"].numpy().tobytes() == want["scales"].tobytes()
        assert got["diag"].numpy().tobytes() == want["diag"].tobytes()


def test_compress_pods_raises():
    """The cross-pod reduction reduces over a mesh's pods: without a mesh it
    raises (on a mesh without pods it is off, as in the reference;
    tests/test_torch_grad_compress.py runs it on one)."""
    _, tc = _configs(3)
    with pytest.raises(ValueError, match="mesh"):
        TrainSetup(Model(tc), TrainConfig(compress_pods=True))


# -- data -------------------------------------------------------------------


@pytest.mark.parametrize("n_prefix", [0, 4])
def test_synthetic_lm_batches_match_reference(n_prefix):
    kw = dict(vocab_size=256, seq_len=40, global_batch=3, seed=7,
              n_prefix=n_prefix, d_model=16)
    ref, port = JaxSyntheticLM(JaxDataConfig(**kw)).batches(), \
        SyntheticLM(DataConfig(**kw)).batches()
    for _ in range(3):
        a, b = next(ref), next(port)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    t = batch_to_device(b, "cpu")
    assert t["tokens"].dtype == torch.int32 and torch.equal(
        t["tokens"], torch.from_numpy(b["tokens"]))


# -- entry points on the CPU ------------------------------------------------


def test_train_cli_on_the_cpu_loss_falls_and_savime_holds_egress(capsys, tmp_path):
    """``python -m repro_torch.launch.train --arch gemma2-27b --smoke
    --intransit --egress grads_int8 --device cpu``, a few steps: the loss
    falls and SAVIME holds a diagnostic for every step."""
    from repro_torch.launch.train import build_parser, train
    args = build_parser().parse_args([
        "--arch", "gemma2-27b", "--smoke", "--intransit", "--egress",
        "grads_int8", "--device", "cpu", "--steps", "16", "--seq", "32",
        "--batch", "4", "--ckpt-every", "8", "--ckpt-dir", str(tmp_path)])
    res = train(args, log=print)
    losses = [m["loss"] for m in res["metrics"]]
    assert len(losses) == 16 and losses[-1] < losses[0]
    assert res["diag"].shape == (16, 2)
    np.testing.assert_allclose(res["diag"][:, 0], losses, rtol=1e-6)
    assert sorted(os.listdir(tmp_path)) == ["step_00000008", "step_00000016"]
    assert "step diagnostics" in capsys.readouterr().out


def test_example_twin_runs_on_the_cpu_without_jax():
    """``examples/torch_train_with_intransit.py --device cpu``, with jax,
    ml_dtypes and repro blocked: one injected failure recovered, falling
    loss, SAVIME holds every step's diagnostics, ``OK``."""
    prog = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['example', '--device', 'cpu', '--steps', '24',\n"
            "            '--ckpt-every', '4']\n"
            f"runpy.run_path({str(ROOT / 'examples' / 'torch_train_with_intransit.py')!r},"
            " run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "restarts=1" in r.stdout
    assert "SAVIME holds 24 step diagnostics" in r.stdout
    assert r.stdout.strip().endswith("OK")
