"""Port parity for the falcon-mamba serve path: repro_torch's config, param
tree, mamba block and Model, converted from the reference's Model.init with
params_from_jax, against repro's on the same tokens; then the serve entry
point against the reference's prefill + greedy decode loop.

Smoke configs (d_model 64, d_inner 128, d_state 8, dt_rank 4): 1 layer uses
the `rem` layout, 3 layers the stacked `scan` layout. Tolerances, relative
to the largest magnitude of the compared tensor (``_close``): f32 compute
2e-5 (f32 rounding in another order, through the conv, the 1-3 layer
recurrence and the GEMMs: measured up to 6.6e-6 of max|logit| ~3; the
stacked weights have the reference's fan-in over the layers axis, std
1/sqrt(3), which makes activations large). bf16 compute: 3e-2 at 1
layer (measured up to 0.9%), 0.1 at 3 layers (measured up to 7.9%, in the
decode steps): the two frameworks round to bf16 at different points (XLA
may keep f32 between fused elementwise ops), and at 3 layers each side's
bf16 logits lie up to 16% (port) and 22% (reference) of max|logit| from
the same model evaluated in f32, so bf16 rounding noise, not the port,
sets that bound. The f32 cases carry the tight check.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, tensor_from_numpy  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import Model, ssm  # noqa: E402

ARCH = "falcon-mamba-7b"
B, S, N_DEC = 2, 40, 4
CPU = torch.device("cpu")
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TOL_BF16_3_LAYERS = 0.1


def _pair(n_layers, compute_dtype):
    kw = dict(n_layers=n_layers, compute_dtype=compute_dtype)
    jcfg = dataclasses.replace(jax_config(ARCH).smoke(), **kw)
    tcfg = dataclasses.replace(get_config(ARCH).smoke(), **kw)
    jm, tm = JaxModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jm, jp, tm, tp


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    want = _np(want)
    got = _np(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _stack_scan(tcache):
    return {k: {f: torch.stack([c[f] for c in per]) for f in per[0]}
            for k, per in tcache["scan"].items()}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_param_count_match_reference(smoke):
    jc, tc = jax_config(ARCH), get_config(ARCH)
    if smoke:
        jc, tc = jc.smoke(), tc.smoke()
    for f in dataclasses.fields(tc):
        if f.name != "ssm":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert dataclasses.asdict(tc.ssm) == dataclasses.asdict(jc.ssm)
    assert tc.d_inner == jc.d_inner
    assert tc.ssm.resolved_dt_rank(tc.d_model) == \
        jc.ssm.resolved_dt_rank(jc.d_model)
    assert tc.param_count() == jc.param_count()
    if not smoke:
        assert (tc.n_layers, tc.d_inner, tc.ssm.resolved_dt_rank(4096)) == \
            (64, 8192, 256)
        assert tc.param_count() == 7_272_398_848


def test_config_rejects_mamba_without_ssm():
    with pytest.raises(ValueError, match="SSMConfig"):
        dataclasses.replace(get_config(ARCH), ssm=None)


@pytest.mark.parametrize("n_layers", [1, 3])
def test_param_tree_matches_reference_specs(n_layers):
    jm, jp, tm, tp = _pair(n_layers, "float32")
    own = tm.init(seed=0, device=CPU)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert {p[-1].key for p, _ in jleaves} >= {"A_log", "D", "in_proj",
                                                "conv_w", "out_proj"}
    for path, leaf in jleaves:
        keys = [p.key for p in path]
        want = torch.from_numpy(np.array(leaf))
        if keys[0] == "scan":
            conv = [tp["scan"][keys[1]][i] for i in range(leaf.shape[0])]
            mine = [own["scan"][keys[1]][i] for i in range(leaf.shape[0])]
            for k in keys[2:]:
                conv = [c[k] for c in conv]
                mine = [m[k] for m in mine]
            conv, mine = torch.stack(conv), torch.stack(mine)
        else:
            conv, mine = tp, own
            for k in keys:
                conv, mine = conv[k], mine[k]
        assert torch.equal(conv, want)
        assert mine.shape == want.shape and mine.dtype == want.dtype
        assert mine.dtype == torch.float32
        if keys[-1] == "A_log":   # deterministic: log(1..N) on every channel
            np.testing.assert_allclose(mine.numpy(), want.numpy(), rtol=2e-7)
            assert float(mine[..., 0].abs().max()) == 0.0


def test_compute_params_keeps_a_log_and_d_in_f32():
    _, _, tm, tp = _pair(3, "bfloat16")
    cp = tm.compute_params(tp)
    for blk in cp["scan"]["0:mamba"]:
        m = blk["mamba"]
        assert m["A_log"].dtype == torch.float32 and m["D"].dtype == torch.float32
        assert m["in_proj"].dtype == torch.bfloat16
        assert m["conv_w"].dtype == torch.bfloat16
        assert m["dt_bias"].dtype == torch.float32       # 1-D: param dtype
    src = tp["scan"]["0:mamba"][1]["mamba"]["A_log"]
    assert torch.equal(cp["scan"]["0:mamba"][1]["mamba"]["A_log"], src)
    # cast to bf16, log 3 = 1.0986 would become 1.1016 and change every decay
    assert not torch.equal(src.to(torch.bfloat16).float(), src)


def test_compute_params_reads_keep_dtype_from_the_specs():
    """compute_params casts by the specs, not by parameter names: in the
    1-layer `rem` layout too, exactly the leaves whose spec says keep_dtype
    (A_log, D) stay f32 among the matrices."""
    _, _, tm, tp = _pair(1, "bfloat16")
    specs = tm.param_specs()["rem"]["0:mamba"]["mamba"]
    assert sorted(k for k, v in specs.items() if v.keep_dtype) == ["A_log", "D"]
    m = tm.compute_params(tp)["rem"]["0:mamba"]["mamba"]
    for k, t in m.items():
        want = torch.bfloat16 if t.dim() >= 2 and not specs[k].keep_dtype \
            else tp["rem"]["0:mamba"]["mamba"][k].dtype
        assert t.dtype == want, k
    assert m["A_log"].dtype == torch.float32


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mamba_block_prefill_and_decode_match_reference(compute_dtype):
    jm, jp, tm, tp = _pair(1, compute_dtype)
    tol = TOL[compute_dtype]
    cdt = jnp.dtype(compute_dtype)
    jblk = jp["rem"]["0:mamba"]["mamba"]
    tblk = tm.compute_params(tp)["rem"]["0:mamba"]["mamba"]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, S + 1, tm.cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(cdt)
    xt = tensor_from_numpy(np.asarray(xj), CPU)
    blk = functools.partial(jssm.mamba_block, cfg=jm.cfg, rules={})
    jy, jc = jax.jit(functools.partial(blk, return_cache=True))(jblk, xj[:, :S])
    with torch.inference_mode():
        ty, tc = ssm.mamba_block(tblk, xt[:, :S], cfg=tm.cfg, return_cache=True)
    assert ty.dtype == xt.dtype
    _close(ty, jy, tol)
    assert tc["conv"].dtype == xt.dtype and tc["h"].dtype == torch.float32
    _close(tc["conv"], jc["conv"], tol)
    _close(tc["h"], jc["h"], tol)
    # one decode step on the S == 1 fast path, from the prefill's cache
    jy1, jc1 = jax.jit(blk)(jblk, xj[:, S:], cache=jc)
    with torch.inference_mode():
        ty1, tc1 = ssm.mamba_block(tblk, xt[:, S:], cfg=tm.cfg, cache=tc)
    _close(ty1, jy1, tol)
    _close(tc1["h"], jc1["h"], tol)
    _close(tc1["conv"], jc1["conv"], tol)


@pytest.mark.parametrize("n_layers,compute_dtype", [
    (1, "float32"), (3, "float32"), (1, "bfloat16"), (3, "bfloat16")])
def test_prefill_cache_and_decode_match_reference(n_layers, compute_dtype):
    jm, jp, tm, tp = _pair(n_layers, compute_dtype)
    tol = TOL_BF16_3_LAYERS if (n_layers, compute_dtype) == (3, "bfloat16") \
        else TOL[compute_dtype]
    tp = tm.compute_params(tp)
    toks = np.random.default_rng(11).integers(0, 256, (B, S + N_DEC))
    j_prefill = jax.jit(functools.partial(jm.prefill, rules={},
                                          max_len=S + N_DEC))
    j_decode = jax.jit(functools.partial(jm.decode_step, rules={}))
    jl, jc = j_prefill(jp, jnp.asarray(toks[:, :S]))
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :S]),
                            max_len=S + N_DEC)
    _close(tl, jl, tol)
    if n_layers == 3:
        assert not jc["rem"] and not tc["rem"]
        jcache, tcache = jc["scan"], _stack_scan(tc)
    else:
        assert not jc["scan"] and not tc["scan"]
        jcache, tcache = jc["rem"], tc["rem"]
    assert sorted(jcache) == sorted(tcache) == ["0:mamba"]
    for f in ("conv", "h"):
        want = jcache["0:mamba"][f]
        assert tcache["0:mamba"][f].dtype == \
            tensor_from_numpy(np.asarray(want), CPU).dtype
        _close(tcache["0:mamba"][f], want, tol)

    for t in range(N_DEC):
        pos = S + t
        jl, jc = j_decode(jp, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.full((B,), pos, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, pos:pos + 1]),
                                    torch.full((B,), pos, dtype=torch.int32), tc)
        _close(tl, jl, tol)


def test_serve_greedy_tokens_match_reference_loop():
    """serve(..., device="cpu") against the reference's prefill + greedy
    decode loop (repro/launch/serve.py) on the same params and prompts."""
    n_new = 6
    jm, jp, tm, tp = _pair(3, "float32")
    prompts = np.random.default_rng(12).integers(0, 256, (B, S))
    j_prefill = jax.jit(functools.partial(jm.prefill, rules={},
                                          max_len=S + n_new))
    j_decode = jax.jit(functools.partial(jm.decode_step, rules={}))
    logits, cache = j_prefill(jp, jnp.asarray(prompts))
    tok = jnp.argmax(logits, -1)[:, None]
    out = [tok]
    for i in range(n_new - 1):
        logits, cache = j_decode(jp, tok, jnp.full((B,), S + i, jnp.int32),
                                 cache)
        tok = jnp.argmax(logits, -1)[:, None]
        out.append(tok)
    ref_tokens = np.asarray(jnp.concatenate(out, axis=1))

    res = serve(tm.cfg, batch=B, prompt_len=S, new_tokens=n_new, device="cpu",
                params=tp, prompts=torch.from_numpy(prompts), log=lambda m: None)
    assert res["tokens"].shape == (B, n_new)
    assert np.array_equal(res["tokens"].numpy(), ref_tokens)


def test_init_cache_matches_reference():
    jm, _, tm, _ = _pair(3, "bfloat16")
    want = params_from_jax(jax.tree.map(np.asarray, jm.init_cache(B, 40)),
                           tm.cfg, CPU)
    got = tm.init_cache(B, 40, device=CPU)
    assert len(got["scan"]["0:mamba"]) == 3
    for g, w in zip(got["scan"]["0:mamba"], want["scan"]["0:mamba"]):
        for f in ("conv", "h"):
            assert g[f].dtype == w[f].dtype and torch.equal(g[f], w[f])
    c = got["scan"]["0:mamba"][0]
    assert c["conv"].shape == (B, 3, 128) and c["conv"].dtype == torch.bfloat16
    assert c["h"].shape == (B, 128, 8) and c["h"].dtype == torch.float32
