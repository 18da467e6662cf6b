"""Port parity for the architectures the port took over from the reference
beside gemma2 and falcon-mamba: gemma3-4b (qk-norm, 5:1 local:global),
qwen2-72b (QKV biases), granite-34b (MQA), paligemma-3b (prefix-LM, head
dim 256), musicgen-medium (plain GELU MLP), llama4-maverick and arctic
(MoE) and recurrentgemma-9b (RG-LRU), each at its ``smoke()`` config.

For each: the config against the reference's (every field, the parameter
counts), the param tree against the reference's specs (converted leaves
equal bit for bit, the port's own init of the same shapes and dtypes), and
prefill logits plus 4 greedy decode steps against the reference's Model on
the same params and tokens, its biases and q/k norm scales set to random
values so that they bind. Then paligemma with prefix embeddings, and
``loss_fn`` with a nonzero MoE aux loss and with a prefix.

Tolerance: f32 compute, 2e-5 of the largest |logit| (~3): f32 rounding in
another order through 2-4 layers (measured up to 7.6e-6 of it); the greedy
tokens equal. bf16 rounding is covered block by block in
test_torch_moe.py and test_torch_rglru.py.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402

NEW_ARCHS = ["gemma3-4b", "qwen2-72b", "granite-34b", "paligemma-3b",
             "musicgen-medium", "llama4-maverick-400b-a17b", "arctic-480b",
             "recurrentgemma-9b"]
CPU = torch.device("cpu")
B, S, N_DEC = 2, 40, 4
REL = 2e-5
# 1-D parameters that are 0 or 1 at init: set at random so that they bind
BIND = ("bq", "bk", "bv", "q_norm", "k_norm", "b_i", "b_r", "conv_b")


def _as_dict(sub):
    return dataclasses.asdict(sub) if dataclasses.is_dataclass(sub) else sub


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    """The reference's init of the smoke config (the compute dtype does not
    enter it) as numpy, the leaves named in BIND drawn at random."""
    rng = np.random.default_rng(17)

    def bind(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1].key in BIND:
            leaf = (1.0 * (path[-1].key.endswith("norm"))
                    + 0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    jm = JaxModel(jax_config(arch).smoke())
    return jax.tree_util.tree_map_with_path(bind, jm.init(jax.random.PRNGKey(0)))


def _pair(arch, **kw):
    jcfg = dataclasses.replace(jax_config(arch).smoke(), **kw)
    tcfg = dataclasses.replace(get_config(arch).smoke(), **kw)
    jp = _reference_params(arch)
    tp = params_from_jax(jp, tcfg, CPU)
    return JaxModel(jcfg), jax.tree.map(jnp.asarray, jp), Model(tcfg), tp


def _close(t, j):
    want = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.float().numpy(), want, rtol=0,
                               atol=REL * max(1.0, float(np.abs(want).max())))


def test_registry_knows_the_reference_architectures():
    assert ARCH_IDS == JAX_ARCH_IDS and len(ARCH_IDS) == 10
    for a in ARCH_IDS:
        assert get_config(a).name == a
        assert get_config(a + "-smoke") == get_config(a).smoke()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_reference(arch):
    for jc, tc in ((jax_config(arch), get_config(arch)),
                   (jax_config(arch).smoke(), get_config(arch).smoke())):
        for f in dataclasses.fields(tc):
            assert _as_dict(getattr(tc, f.name)) == _as_dict(getattr(jc, f.name)), f.name
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc.layer_kinds == jc.layer_kinds and tc.d_rnn == jc.d_rnn
    assert get_config(arch).__doc__ is not None


@pytest.mark.parametrize("arch,field,sub", [
    ("llama4-maverick-400b-a17b", "moe", "MoEConfig"),
    ("recurrentgemma-9b", "rglru", "RGLRUConfig")])
def test_config_needs_the_sub_config_of_its_kinds(arch, field, sub):
    with pytest.raises(ValueError, match=sub):
        dataclasses.replace(get_config(arch), **{field: None})


def test_config_refuses_tensor_parallel_head_padding():
    """Padding the heads for tensor parallelism is taken where each KV
    group pads alike (the reference's rule pad_heads_to % n_kv_heads == 0)
    and refused where it does not."""
    assert dataclasses.replace(get_config("paligemma-3b"),
                               pad_heads_to=16).pad_heads_to == 16
    assert dataclasses.replace(get_config("gemma2-27b"),
                               pad_heads_to=48).pad_heads_to == 48
    with pytest.raises(ValueError, match="no multiple of n_kv_heads 16"):
        dataclasses.replace(get_config("gemma2-27b"), pad_heads_to=40)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_tree_matches_reference_specs(arch):
    """Converted leaves equal the reference's bit for bit (the f32 router,
    3-D expert weights, lam and the 3-D w_i/w_r among them); the port's own
    init gives every leaf the reference's shape and dtype."""
    jm, jp, tm, tp = _pair(arch)
    own = tm.init(seed=0, device=CPU)
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    names = set()
    for path, leaf in leaves:
        keys = [p.key for p in path]
        names.add(keys[-1])
        conv, mine = tp, own
        if keys[0] == "scan":
            conv = torch.stack([c for c in _walk(tp["scan"][keys[1]], keys[2:])])
            mine = torch.stack([m for m in _walk(own["scan"][keys[1]], keys[2:])])
        else:
            for k in keys:
                conv, mine = conv[k], mine[k]
        want = np.asarray(leaf)
        assert str(conv.dtype).split(".")[-1] == want.dtype.name, keys
        assert torch.equal(conv, torch.from_numpy(want.copy())), keys
        assert mine.shape == want.shape and mine.dtype == conv.dtype, keys
    kinds = set(get_config(arch).layer_pattern)
    if "moe" in kinds:
        assert {"router", "wi", "wo"} <= names
    if "rglru" in kinds:
        assert {"lam", "w_i", "w_r", "w_x", "w_y"} <= names


def _walk(per_period, keys):
    for t in per_period:
        for k in keys:
            t = t[k]
        yield t


def test_init_fan_in_is_the_leading_axis():
    """As the reference's ParamSpec.materialize, the port takes the init's
    fan-in from a leaf's leading axis: 1/sqrt(E) for an expert weight
    (E, M, F) and 1/sqrt(n_blocks) for a gate (nb, bw, bw), not the width
    the product sums over (ROADMAP.md, reference caveats)."""
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b").smoke(),
                              n_layers=2)
    p = Model(cfg).init(seed=1, device=CPU)["rem"]["1:moe"]["moe"]
    rcfg = dataclasses.replace(get_config("recurrentgemma-9b").smoke(),
                               n_layers=1)
    g = Model(rcfg).init(seed=1, device=CPU)["rem"]["0:rglru"]["rglru"]
    tn_std = 0.8796   # the std of a normal truncated at +-2 sigma
    for leaf, fan_in in ((p["wi"], 8), (p["wo"], 8), (g["w_i"], 2), (g["w_r"], 2)):
        assert abs(float(leaf.std()) / (tn_std / fan_in ** 0.5) - 1) < 0.05


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    jm, jp, tm, tp = _pair(arch, compute_dtype="float32")
    tp = tm.compute_params(tp)
    prompts = np.random.default_rng(11).integers(0, 256, (B, S))
    j_prefill = jax.jit(functools.partial(jm.prefill, rules={},
                                          max_len=S + N_DEC))
    j_decode = jax.jit(functools.partial(jm.decode_step, rules={}))
    jl, jc = j_prefill(jp, jnp.asarray(prompts))
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, torch.from_numpy(prompts), max_len=S + N_DEC)
    _close(tl, jl)
    for i in range(N_DEC):
        jt = jnp.argmax(jl, -1)[:, None]
        tt = tl.argmax(-1)[:, None]
        assert np.array_equal(tt.numpy(), np.asarray(jt)), i
        pos = S + i
        jl, jc = j_decode(jp, jt, jnp.full((B,), pos, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, tt, torch.full((B,), pos,
                                                       dtype=torch.int32), tc)
        _close(tl, jl)


def test_paligemma_prefix_embed_matches_reference():
    """Prefix embeddings before the text, attended bidirectionally: the
    prefill logits, the cache and 4 decode steps after it."""
    jm, jp, tm, tp = _pair("paligemma-3b", compute_dtype="float32")
    P = tm.cfg.n_prefix
    assert P == 4 and tm.cfg.prefix_bidirectional
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, 256, (B, S))
    pe = rng.standard_normal((B, P, 64)).astype(np.float32)
    max_len = P + S + N_DEC
    jl, jc = jm.prefill(jp, jnp.asarray(prompts), {}, jnp.asarray(pe), max_len)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, torch.from_numpy(prompts),
                            prefix_embed=torch.from_numpy(pe), max_len=max_len)
    _close(tl, jl)
    assert tc["scan"]["0:dense"][0]["k"].shape == (B, max_len, 16)
    j_decode = jax.jit(functools.partial(jm.decode_step, rules={}))
    toks = rng.integers(0, 256, (B, N_DEC))
    for i in range(N_DEC):
        pos = P + S + i
        jl, jc = j_decode(jp, jnp.asarray(toks[:, i:i + 1]),
                          jnp.full((B,), pos, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                    torch.full((B,), pos, dtype=torch.int32), tc)
        _close(tl, jl)


@pytest.mark.parametrize("arch,prefix", [("llama4-maverick-400b-a17b", False),
                                         ("arctic-480b", False),
                                         ("paligemma-3b", True)])
def test_loss_fn_matches_reference(arch, prefix):
    """The training loss with its MoE aux terms (nonzero in the moe archs),
    and with prefix embeddings (the loss on the text positions only)."""
    jm, jp, tm, tp = _pair(arch, compute_dtype="float32")
    rng = np.random.default_rng(13)
    batch = {"tokens": rng.integers(0, 256, (B, S)),
             "targets": rng.integers(0, 256, (B, S)),
             "loss_mask": (rng.uniform(size=(B, S)) < 0.9).astype(np.float32)}
    if prefix:
        batch["prefix_embed"] = rng.standard_normal(
            (B, tm.cfg.n_prefix, 64)).astype(np.float32)
    jloss, jm_ = jax.jit(functools.partial(jm.loss_fn, rules={}, xent_chunk=16))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tm_ = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                            xent_chunk=16)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-6)
    for k in ("nll", "z2", "moe_lb", "moe_z"):
        np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=2e-6,
                                   atol=1e-7)
    if not prefix:
        assert float(tm_["moe_lb"]) > 0.5 and float(tm_["moe_z"]) > 0
