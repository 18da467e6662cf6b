"""Port parity for the MoE block: repro_torch.models.moe against
repro.models.moe on the same params (the reference's init, converted) and
the same inputs, for the llama4 smoke config (top-1, shared expert) and the
arctic smoke config (top-2, dense residual), 8 experts of width 96.

Checked: the block's output and both aux losses at prefill (a group a
sequence) and at decode (one group of B tokens); a router biased towards
expert 0, which drives most choices past the capacity, where the dispatch
plan's integers (the slot of each choice, the token in each slot, the drop
count) must equal the reference's and a numpy recount's exactly; and the
router staying f32 under ``compute_params`` with bf16 compute.

Tolerances, relative to the largest magnitude of the compared tensor: f32
compute 1e-5 (f32 GEMMs summed in another order; the routing, the plan and
the combine are the same arithmetic), the aux losses 1e-6; bf16 compute
3e-2 (the two frameworks round the expert products to bf16 at different
points; the routing is f32 on both sides).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ["llama4-maverick-400b-a17b", "arctic-480b"]


def _pair(arch, compute_dtype="float32", router_bias=0.0):
    """The smoke config's moe params from the reference's init, as a jax
    tree and as the port's tree. ``router_bias`` adds to the router's row 0,
    which an input with a large feature 0 turns into a pull towards
    expert 0."""
    jcfg = dataclasses.replace(jax_config(arch).smoke(),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(get_config(arch).smoke(),
                               compute_dtype=compute_dtype)
    jp = jax.tree.map(np.asarray, init_params(jmoe.moe_specs(jcfg),
                                              jax.random.PRNGKey(3)))
    jp["router"] = jp["router"].copy()
    jp["router"][0, 0] += router_bias
    tp = tree_map(lambda a: tensor_from_numpy(a, CPU), jp)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp


def _x(shape, dtype, feature0=None, seed=5):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if feature0 is not None:
        x[..., 0] = feature0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    return jx, tensor_from_numpy(np.asarray(jx), CPU)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _ref_plan(jcfg, jp, jx):
    """The reference's dispatch plan for tokens jx (G, T, M): the lines of
    repro/models/moe.py:50-74 (routing, cumsum positions, slot scatter),
    which moe_block does not return."""
    m = jcfg.moe
    G, T, _ = jx.shape
    E, k = m.n_experts, m.top_k
    C = jmoe._capacity(T, k, E, m.capacity_factor)
    logits = jnp.einsum("gtm,me->gte", jx.astype(jnp.float32), jp["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(G, T * k)
    oh = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = (jnp.cumsum(oh, axis=1) * oh).sum(-1)
    keep = (pos >= 1) & (pos <= C)
    slot = jnp.where(keep, flat_e * C + (pos - 1), E * C)
    tok = jnp.tile(jnp.arange(T)[:, None], (1, k)).reshape(T * k)
    token_for_slot = jnp.zeros((G, E * C), jnp.int32).at[
        jnp.arange(G)[:, None], slot].set(jnp.broadcast_to(tok, (G, T * k)),
                                          mode="drop")
    return C, np.asarray(token_for_slot), np.asarray(~keep).sum(-1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 24), (4, 1)], ids=["prefill", "decode"])
def test_moe_block_matches_reference(arch, shape):
    jcfg, tcfg, jp, tp = _pair(arch)
    jx, x = _x((*shape, 64), "float32")
    jy, jaux = jmoe.moe_block(jp, jx, cfg=jcfg, rules={})
    y, aux = moe.moe_block(tp, x, cfg=tcfg)
    assert y.shape == x.shape and y.dtype == x.dtype
    _close(y, jy, 1e-5)
    for name in ("moe_lb", "moe_z"):
        assert aux[name].dtype == torch.float32 and aux[name].dim() == 0
        _close(aux[name], jaux[name], 1e-6)
    # decode puts all B tokens into one group, capacity ceil(B*k/E*1.25)
    G, T = (1, shape[0]) if shape[1] == 1 else shape
    plan = moe.route(tp["router"], x.reshape(G, T, 64), top_k=tcfg.moe.top_k,
                     capacity_factor=1.25)
    assert plan["token_for_slot"].shape == (G, 8 * plan["C"])
    assert plan["C"] == jmoe._capacity(T, tcfg.moe.top_k, 8, 1.25)


@pytest.mark.parametrize("arch", ARCHS)
def test_over_capacity_dispatch_plan_equals_reference(arch):
    """A router pulled towards expert 0: the dispatch plan's integers equal
    the reference's and a numpy recount's; the output and aux losses too."""
    jcfg, tcfg, jp, tp = _pair(arch, router_bias=4.0)
    jx, x = _x((2, 24, 64), "float32", feature0=3.0)
    C, want_tfs, want_dropped = _ref_plan(jcfg, jp, jx)
    plan = moe.route(tp["router"], x, top_k=tcfg.moe.top_k,
                     capacity_factor=tcfg.moe.capacity_factor)
    assert plan["C"] == C == 4 * tcfg.moe.top_k   # ceil(24 k / 8 * 1.25)
    np.testing.assert_array_equal(plan["token_for_slot"].numpy(), want_tfs)
    np.testing.assert_array_equal(plan["dropped"].numpy(), want_dropped)
    # recount from the router's probabilities: choices past each expert's C
    top = np.argsort(-plan["probs"].numpy(), axis=-1, kind="stable")
    top = top[..., :tcfg.moe.top_k].reshape(2, -1)
    counts = np.stack([np.bincount(t, minlength=8) for t in top])
    recount = np.maximum(counts - C, 0).sum(-1)
    np.testing.assert_array_equal(plan["dropped"].numpy(), recount)
    assert recount.min() >= 10          # most of the 24 tokens chose expert 0
    jy, jaux = jmoe.moe_block(jp, jx, cfg=jcfg, rules={})
    y, aux = moe.moe_block(tp, x, cfg=tcfg)
    _close(y, jy, 1e-5)
    for name in ("moe_lb", "moe_z"):
        _close(aux[name], jaux[name], 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_bf16_compute_matches_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch, compute_dtype="bfloat16")
    jx, x = _x((2, 24, 64), "bfloat16")
    jy, jaux = jmoe.moe_block(jp, jx, cfg=jcfg, rules={})
    y, aux = moe.moe_block(tp, x, cfg=tcfg)   # weights cast at use
    assert y.dtype == torch.bfloat16
    _close(y, jy, 3e-2)
    for name in ("moe_lb", "moe_z"):
        _close(aux[name], jaux[name], 1e-6)   # routing is f32 on both sides


def test_compute_params_keeps_the_router_f32():
    """The router's spec says f32 and keep_dtype: Model.compute_params casts
    the expert weights to bf16 and leaves the router alone."""
    cfg = get_config("llama4-maverick-400b-a17b").smoke()
    m = Model(cfg)
    p = m.compute_params(m.init(seed=0, device=CPU))
    blk = p["rem"]["1:moe"]["moe"]
    assert blk["router"].dtype == torch.float32
    assert blk["wi"].dtype == blk["wo"].dtype == torch.bfloat16
    assert blk["shared"]["wi"].dtype == torch.bfloat16
