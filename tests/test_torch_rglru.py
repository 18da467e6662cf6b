"""Port parity for the RG-LRU block (recurrentgemma-9b): repro_torch.models.
rglru against repro.models.rglru on the same params (the reference's init,
converted) and the same inputs, at the smoke widths (d_model 64, d_rnn 64,
blocks of 32); and the port's doubling scan against a sequential numpy
oracle in float64.

Checked: a prefill's output, final state h and conv cache, then three
decode steps from that cache, for the reference's init (lam = 1: a near
e^-5) and for lam = -8 (a = 1 - O(1e-3): a long memory, where rounding in
the scan would accumulate).

Tolerances, relative to the largest magnitude of the compared tensor: f32
compute 1e-5 for the block at the reference's init (the doubling scan sums
in another order than jax's associative_scan; the GEMMs too), 1e-4 at
lam = -8: there 1 - exp(2 log_a) cancels to ~3e-3, so the two frameworks'
exp, one ulp apart, give betas ~4e-5 apart relative (measured 2.8e-5 of
max |h|); the conv cache after a prefill is the same values copied, so
equal. The scan against the float64 oracle: 1e-5 of max |h|
(f32 rounding over at most log2(S) combining levels, with a products near
1). bf16 compute 3e-2 (bf16 rounding at different points).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.layers import init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402

ARCH = "recurrentgemma-9b"
CPU = torch.device("cpu")
B, S = 2, 37


def _pair(compute_dtype, lam=None):
    jcfg = dataclasses.replace(jax_config(ARCH).smoke(),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(get_config(ARCH).smoke(),
                               compute_dtype=compute_dtype)
    jp = jax.tree.map(np.asarray, init_params(jrglru.rglru_specs(jcfg),
                                              jax.random.PRNGKey(4)))
    rng = np.random.default_rng(6)
    for name in ("b_i", "b_r", "conv_b"):     # zero at init: make them bind
        jp[name] = (0.1 * rng.standard_normal(jp[name].shape)).astype(np.float32)
    if lam is not None:
        jp["lam"] = np.full_like(jp["lam"], lam)
    tp = tree_map(lambda a: tensor_from_numpy(a, CPU), jp)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1e-3, float(np.abs(want).max())))


@pytest.mark.parametrize("lam,compute_dtype,rel", [
    (None, "float32", 1e-5), (-8.0, "float32", 1e-4),
    (None, "bfloat16", 3e-2), (-8.0, "bfloat16", 3e-2)],
    ids=["init-f32", "long_memory-f32", "init-bf16", "long_memory-bf16"])
def test_rglru_block_prefill_and_decode_match_reference(lam, compute_dtype, rel):
    jcfg, tcfg, jp, tp = _pair(compute_dtype, lam)
    x = np.random.default_rng(7).standard_normal((B, S + 3, 64)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, compute_dtype))
    tx = tensor_from_numpy(np.asarray(jx), CPU)
    jy, jc = jrglru.rglru_block(jp, jx[:, :S], cfg=jcfg, rules={},
                                return_cache=True)
    y, c = rglru.rglru_block(tp, tx[:, :S], cfg=tcfg, return_cache=True)
    assert y.shape == (B, S, 64) and y.dtype == tx.dtype
    assert c["h"].dtype == torch.float32 and c["h"].shape == (B, 64)
    assert c["conv"].shape == (B, 3, 64) and c["conv"].dtype == tx.dtype
    _close(y, jy, rel)
    _close(c["h"], jc["h"], rel)
    np.testing.assert_array_equal(c["conv"].float().numpy(),
                                  np.asarray(jc["conv"], np.float32))
    for t in range(S, S + 3):
        jy, jc = jrglru.rglru_block(jp, jx[:, t:t + 1], cfg=jcfg, rules={},
                                    cache=jc)
        y, c = rglru.rglru_block(tp, tx[:, t:t + 1], cfg=tcfg, cache=c)
        _close(y, jy, rel)
        _close(c["h"], jc["h"], rel)
        _close(c["conv"], jc["conv"], rel)


def _oracle(a, b, h0):
    h, out = h0.astype(np.float64), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, 1)


@pytest.mark.parametrize("S_", [1, 2, 37, 100, 129])
@pytest.mark.parametrize("near_one", [False, True])
def test_scan_matches_sequential_oracle(S_, near_one):
    rng = np.random.default_rng(S_)
    if near_one:   # a = 1 - u * 1e-4: products stay near 1 for the whole run
        a = 1.0 - rng.uniform(0, 1e-4, (2, S_, 16))
    else:
        a = rng.uniform(0, 1, (2, S_, 16))
    a = a.astype(np.float32)
    b = rng.standard_normal((2, S_, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32)
    h, h_last = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(h0))
    want = _oracle(a.astype(np.float64), b.astype(np.float64), h0)
    assert h.dtype == torch.float32 and h.shape == (2, S_, 16)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(h.numpy(), want, rtol=0, atol=tol)
    assert torch.equal(h_last, h[:, -1])


def test_scan_is_differentiable():
    """The doubling scan builds new tensors each pass, so autograd takes
    its gradient: the gradient of sum(h) against the oracle's, in f64."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.uniform(0.5, 1, (1, 9, 4)), requires_grad=True)
    b = torch.tensor(rng.standard_normal((1, 9, 4)), requires_grad=True)
    h0 = torch.tensor(rng.standard_normal((1, 4)))
    h, _ = rglru.rglru_scan(a, b, h0)
    gb, = torch.autograd.grad(h.sum(), b)
    # d sum(h) / d b_t = 1 + a_{t+1} + a_{t+1} a_{t+2} + ...
    an = a.detach().numpy()[0]
    want = np.zeros_like(an)
    acc = np.zeros(4)
    for t in range(8, -1, -1):
        acc = 1 + (an[t + 1] * acc if t < 8 else 0)
        want[t] = acc
    np.testing.assert_allclose(gb.numpy()[0], want, rtol=1e-12)
