"""Port parity for the int8 error-feedback cross-pod reduction
(``repro_torch/optim/grad_compress.py`` and ``train_step._pod_reduce``)
against the reference's ``grad_compress._quant_blocks``, ``_flatten``,
``_unflatten``, ``error_state`` and ``train_step._pod_reduce``.

The reference's ring runs here under ``jax.vmap(..., axis_name="pod")``:
its ``ppermute`` and ``all_gather`` take the vmapped axis as the pod axis.
The reference runs op by op, as written: under ``jax.jit`` XLA rewrites
``amax / 127.0`` as ``amax * (1/127)``, which puts a scale one ulp off in a
few blocks (4 of the 100 here), while the port divides.
(Its own ``shard_map`` entry points fail in this jax, which is why
``tests/test_distributed.py``'s two compressed checks are red; the port is
not held against them.) The port's ring runs one gloo process a pod.

Tolerances: none. Quantized bytes, scales, the flat layout, the reduced
flat and the new residual are held equal element for element. The values
are normal floats, so the one rule where the two quantizers part (a block
whose amax/127 underflows: scale 1 in the port and the host codec, amax/127
in the reference) never applies; an all-zero block, where both give scale
1, is included.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_dist  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.train.train_step import _pod_reduce as jax_pod_reduce  # noqa: E402
from repro_torch.convert import to_reference_layout  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.optim import grad_compress as gc  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402
from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.train import TrainConfig, TrainSetup  # noqa: E402

QB = gc.QBLOCK


def _mixed_blocks(n_blocks, seed):
    """Normal values whose scale varies by block over 8 decades, with one
    all-zero block (the middle one) where there is more than one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_blocks, QB)).astype(np.float32)
    x *= (10.0 ** rng.uniform(-6, 2, n_blocks)).astype(np.float32)[:, None]
    if n_blocks > 1:
        x[n_blocks // 2] = 0.0
    return x


@pytest.mark.parametrize("n_blocks", [1, 37, 100])
def test_quant_blocks_equals_the_reference_byte_for_byte(n_blocks):
    x = _mixed_blocks(n_blocks, n_blocks)
    jq, js = (np.asarray(a) for a in jgc._quant_blocks(jnp.asarray(x)))
    q, s = gc.quant_blocks(torch.from_numpy(x))
    assert q.dtype == torch.int8 and q.shape == (n_blocks, QB)
    assert s.dtype == torch.float32 and s.shape == (n_blocks,)
    assert q.numpy().tobytes() == jq.tobytes()
    assert s.numpy().tobytes() == js.tobytes()
    assert np.abs(jq).max() == 127
    if n_blocks > 1:
        assert float(s[n_blocks // 2]) == 1.0 and not q[n_blocks // 2].any()
    back = gc.dequant_blocks(q, s).numpy()
    assert back.tobytes() == (jq.astype(np.float32) * js[:, None]).tobytes()


def _tree(rng, sizes):
    return {f"l{i}": rng.standard_normal(n).astype(np.float32)
            for i, n in enumerate(sizes)}


@pytest.mark.parametrize("n_pods", [1, 2, 3])
def test_flatten_pads_as_the_reference_and_unflatten_round_trips(n_pods):
    """5 * QBLOCK - 55 values in four leaves: ceil(n/QBLOCK) = 5 rows, a
    multiple of neither 2 nor 3 pods (the reference's seed-red case at 2
    pods had 3 rows); the rows pad to a multiple of n_pods, as error_state
    sizes the residual."""
    rng = np.random.default_rng(n_pods)
    tree = _tree(rng, [2 * QB + 5, 7, 3 * QB - 100, 33])
    want, want_pad = jgc._flatten({k: jnp.asarray(v) for k, v in tree.items()},
                                  n_pods)
    want = np.asarray(want)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    flat, pad = gc.flatten(ttree, n_pods)
    assert flat.shape == want.shape and pad == want_pad
    assert flat.shape[0] % n_pods == 0
    assert flat.numpy().tobytes() == want.tobytes()
    assert gc.error_state(ttree, n_pods) == jgc.error_state(
        {k: jnp.asarray(v) for k, v in tree.items()}, n_pods).shape
    back = gc.unflatten(flat, pad, ttree)
    assert sorted(back) == sorted(tree)
    for k in tree:
        assert back[k].shape == tree[k].shape and np.array_equal(back[k].numpy(), tree[k])
    ref_back = jgc._unflatten(jnp.asarray(want), want_pad, tree)
    for k in tree:
        assert np.array_equal(np.asarray(ref_back[k]), back[k].numpy())


def _reference_ring(flats, errs):
    n = flats.shape[0]
    red, new_err = jax.vmap(lambda f, e: jax_pod_reduce(f, e, n),
                            axis_name="pod")(flats, errs)
    return np.asarray(red), np.asarray(new_err)


@pytest.mark.parametrize("n_pods", [2, 3])
def test_ring_equals_the_reference_pod_reduce(n_pods):
    """Each pod its own gradients (normal values, block scales over 8
    decades) and a nonzero residual: every pod's reduced flat and new
    residual equal the reference's element for element, and the wire
    carries each block as 1 B of int8 a value plus its 4 B scale, once in
    the reduce-scatter and once in the all-gather."""
    rows = 2 * n_pods
    flats = np.stack([_mixed_blocks(rows, 10 * n_pods + p) for p in range(n_pods)])
    rng = np.random.default_rng(n_pods)
    errs = (rng.standard_normal(flats.shape) * 1e-3).astype(np.float32)
    want_red, want_err = _reference_ring(flats, errs)
    got = run_ranks(_torch_dist.ring, n_pods, flats, errs)
    for p, (red, new_err, wire) in enumerate(got):
        assert red.tobytes() == want_red[p].tobytes(), p
        assert new_err.tobytes() == want_err[p].tobytes(), p
        assert red.tobytes() == got[0][0].tobytes()
        assert wire["bytes"] == 2 * (n_pods - 1) * (rows // n_pods) * (QB + 4)


def test_compressed_pod_allreduce_on_a_tree_at_nondivisible_rows():
    """``compressed_pod_allreduce`` on a two-leaf tree of 2*QBLOCK + 12
    values (3 rows, padded to 4 at 2 pods: the case of the reference's
    seed-red check), each pod its own leaves: the tree comes back in its
    shapes and equals the reference's ring, unflattened."""
    rng = np.random.default_rng(7)
    tree = {"w": rng.standard_normal((2, 2 * QB + 5)).astype(np.float32),
            "b": rng.standard_normal((2, 7)).astype(np.float32)}
    rows = gc.error_state({"w": tree["w"][0], "b": tree["b"][0]}, 2)[0]
    assert rows == 4
    err = (rng.standard_normal((2, rows, QB)) * 1e-3).astype(np.float32)
    flats = np.stack([np.asarray(jgc._flatten({k: jnp.asarray(v[p]) for k, v in tree.items()},
                                              2)[0]) for p in range(2)])
    want_red, want_err = _reference_ring(flats, err)
    got = run_ranks(_torch_dist.tree_allreduce, 2, (2, 1, 1), tree, err)
    for p, (red, new_err) in enumerate(got):
        want = jgc._unflatten(jnp.asarray(want_red[p]), 4 * QB - 2 * QB - 12,
                              {k: v[p] for k, v in tree.items()})
        for k in tree:
            assert red[k].shape == tree[k][p].shape
            assert red[k].tobytes() == np.asarray(want[k]).tobytes(), (p, k)
        assert new_err.tobytes() == want_err[p].tobytes()


def test_compressed_step_equals_the_single_process_composition():
    """Two steps at mesh 2x1x1 with compress_pods: each rank's step against
    the composition in one process of its pieces: every pod's flat
    gradients (as the step flattened them) -> the reference's _pod_reduce
    -> the port's AdamW from the same state. The reduced grads and the
    residual equal the reference's element for element at both steps (the
    second with the first's residual); the loss is the mean of the pods'
    losses; params after step 1 (LR 0) equal the initial ones and after
    step 2 those of the composition within 1e-6 of each leaf's max (the
    global norm sums in another order per process); the ranks' params are
    bit for bit the same."""
    got = run_ranks(_torch_dist.train_steps, 2, (2, 1, 1), ("pod", "data", "model"),
                    {"n_layers": 4}, {"compress_pods": True})
    assert got[0]["params"].keys() == got[1]["params"].keys()
    for a, b in zip(jax.tree.leaves(got[0]["params"]), jax.tree.leaves(got[1]["params"])):
        assert a.tobytes() == b.tobytes()
    err = None
    for i in range(2):
        flats = np.stack([g["reduces"][i]["flat"] for g in got])
        errs = np.stack([g["reduces"][i]["err"] for g in got])
        if err is not None:
            assert errs.tobytes() == err.tobytes()
        red, err = _reference_ring(flats, errs)
        for p, g in enumerate(got):
            assert g["reduces"][i]["reduced"].tobytes() == red[p].tobytes(), (i, p)
            assert g["reduces"][i]["new_err"].tobytes() == err[p].tobytes(), (i, p)
    # the composition in one process: the pods' losses on their own rows,
    # then the port's AdamW on the reduced grads of both steps
    cfg = _torch_dist.smoke_config(n_layers=4)
    setup = TrainSetup(Model(cfg), TrainConfig(**_torch_dist.STEP_CFG))
    params = setup.init_state(7, "cpu")["params"]
    batch = _torch_dist.global_batch(cfg)
    half = _torch_dist.B // 2
    pod_losses = [float(setup._value_and_grad(params, {
        k: torch.from_numpy(v[p * half:(p + 1) * half].copy())
        for k, v in batch.items()})[0]) for p in range(2)]
    for g in got:
        assert g["metrics"][0]["loss"] == pytest.approx(np.mean(pod_losses), rel=1e-5)
    n_values = sum(t.numel() for t in tree_leaves(params))
    opt = adamw_init(params)
    for i in range(2):
        red = torch.from_numpy(got[0]["reduces"][i]["reduced"].copy())
        grads = gc.unflatten(red, red.numel() - n_values, params)
        lr = warmup_cosine(torch.tensor(i, dtype=torch.int32), peak_lr=1e-2,
                           warmup_steps=2, total_steps=10)
        params, opt, stats = adamw_update(grads, opt, params, lr, AdamWConfig(),
                                          setup.decay)
        assert float(stats["grad_norm"]) == pytest.approx(
            got[0]["metrics"][i]["grad_norm"], rel=1e-6)
    want = to_reference_layout(params)
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        b = got[0]["params"]
        for k in path:
            b = b[k.key]
        err_rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
        assert err_rel <= 1e-6, (path, err_rel)
