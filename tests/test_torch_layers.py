"""Port parity: repro_torch.models.layers against repro.models.layers.

Inputs come from a numpy seed and go to both; f32 throughout, atol 1e-5
(summation order and libm differences only).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32)
    _close(jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6, plus_one),
           tl.rms_norm(_t(x), _t(s), 1e-6, plus_one))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 60, (2, 7)).astype(np.int32)
    _close(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta),
           tl.rope(_t(x), _t(pos), theta))


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap(cap):
    x = np.random.default_rng(2).standard_normal(100).astype(np.float32) * 80
    _close(jl.softcap(jnp.asarray(x), cap), tl.softcap(_t(x), cap), atol=2e-5)


@pytest.mark.parametrize("scale", [False, True])
def test_embed_and_tied_unembed(scale):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 64)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 6))
    je = jl.embed({"table": jnp.asarray(table)}, jnp.asarray(toks), scale,
                  jnp.float32)
    te = tl.embed({"table": _t(table)}, _t(toks), scale, torch.float32)
    _close(je, te)
    _close(jl.unembed({"table": jnp.asarray(table)}, je, True),
           tl.unembed({"table": _t(table)}, te, True), atol=1e-4)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_glu_mlp(act):
    rng = np.random.default_rng(4)
    p = {k: rng.standard_normal(s).astype(np.float32) / math.sqrt(s[0])
         for k, s in (("wi", (64, 128)), ("wg", (64, 128)), ("wo", (128, 64)))}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    _close(jl.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  act, {}),
           tl.mlp({k: _t(v) for k, v in p.items()}, _t(x), act))


def test_param_init_is_seeded_truncated_fan_in_normal():
    spec = tl.ParamSpec((400, 300))
    a = spec.materialize(torch.Generator().manual_seed(7), torch.device("cpu"))
    b = spec.materialize(torch.Generator().manual_seed(7), torch.device("cpu"))
    assert torch.equal(a, b) and a.dtype == torch.float32
    std = 1 / math.sqrt(400)
    assert float(a.abs().max()) <= 2 * std * (1 + 1e-6)
    # a standard normal truncated at +-2 sigma has std 0.8796
    assert abs(float(a.std()) / std - 0.8796) < 0.01
    assert torch.equal(tl.ParamSpec((3,), init="neg_ones").materialize(
        None, torch.device("cpu")), -torch.ones(3))


def test_bfloat16_numpy_conversion_is_bit_exact():
    x = jnp.asarray(np.random.default_rng(5).standard_normal(257),
                    jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x), torch.device("cpu"))
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(x).view(np.int16))
