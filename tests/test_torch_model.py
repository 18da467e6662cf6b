"""Port parity for the gemma2 serve path: repro_torch's Model, converted from
the reference's Model.init with params_from_jax, against repro's Model on
the same tokens; then the serve entry point against the reference's
prefill + greedy decode loop.

Smoke configs (window 32) with a 48-token prompt, so the window binds:
3 layers use the `rem` layout, 4 layers the stacked `scan` layout.
Tolerances: f32 compute atol 1e-4 on logits of magnitude ~1 (the 4-layer
scan weights have the reference's fan-in over the layers axis, std ~0.7,
which amplifies f32 rounding); bf16 compute atol 3e-2 (a few bf16 steps at
|logit| ~2: the two frameworks round to bf16 at different points). Cached
k/v are held to the same tolerance times their largest magnitude (up to
~20 in the 4-layer case).
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402

B, S, N_DEC = 2, 48, 4
CPU = torch.device("cpu")


def _pair(n_layers, compute_dtype):
    kw = dict(n_layers=n_layers, compute_dtype=compute_dtype)
    jcfg = dataclasses.replace(jax_config("gemma2-27b").smoke(), **kw)
    tcfg = dataclasses.replace(get_config("gemma2-27b").smoke(), **kw)
    jm, tm = JaxModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jm, jp, tm, tp


def _jax_steps(jm, max_len):
    """The reference's prefill and decode step, jitted as its launcher runs
    them (repro/launch/serve.py)."""
    return (jax.jit(functools.partial(jm.prefill, rules={}, max_len=max_len)),
            jax.jit(functools.partial(jm.decode_step, rules={})))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _stack_scan(tcache):
    """The port's per-period scan caches stacked as the reference stacks them."""
    return {k: {f: torch.stack([c[f] for c in per]) for f in per[0]}
            for k, per in tcache["scan"].items()}


def test_config_matches_reference():
    for jc, tc in ((jax_config("gemma2-27b"), get_config("gemma2-27b")),
                   (jax_config("gemma2-27b").smoke(),
                    get_config("gemma2-27b").smoke())):
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.param_count() == jc.param_count()
    assert get_config("gemma2-27b").query_scale == 144 ** -0.5


@pytest.mark.parametrize("n_layers", [3, 4])
def test_param_tree_matches_reference_specs(n_layers):
    jm, jp, tm, tp = _pair(n_layers, "float32")
    own = tm.init(seed=0, device=CPU)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) > 0
    for path, leaf in jleaves:
        keys = [p.key for p in path]
        if keys[0] == "scan":
            conv = [tp["scan"][keys[1]][i] for i in range(leaf.shape[0])]
            mine = [own["scan"][keys[1]][i] for i in range(leaf.shape[0])]
            for k in keys[2:]:
                conv = [c[k] for c in conv]
                mine = [m[k] for m in mine]
            assert torch.equal(torch.stack(conv), torch.from_numpy(np.array(leaf)))
            assert torch.stack(mine).shape == leaf.shape
        else:
            conv, mine = tp, own
            for k in keys:
                conv, mine = conv[k], mine[k]
            assert torch.equal(conv, torch.from_numpy(np.array(leaf)))
            assert mine.shape == leaf.shape and mine.dtype == torch.float32


@pytest.mark.parametrize("n_layers,compute_dtype,atol", [
    (3, "float32", 1e-4), (4, "float32", 1e-4), (3, "bfloat16", 3e-2)])
def test_prefill_cache_and_decode_match_reference(n_layers, compute_dtype, atol):
    jm, jp, tm, tp = _pair(n_layers, compute_dtype)
    tp = tm.compute_params(tp)
    toks = np.random.default_rng(11).integers(0, 256, (B, S + N_DEC))
    j_prefill, j_decode = _jax_steps(jm, S + N_DEC)
    jl, jc = j_prefill(jp, jnp.asarray(toks[:, :S]))
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :S]),
                            max_len=S + N_DEC)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=atol, rtol=0)

    if n_layers == 4:
        assert not jc["rem"] and not tc["rem"]
        jcache, tcache = jc["scan"], _stack_scan(tc)
    else:
        assert not jc["scan"] and not tc["scan"]
        jcache, tcache = jc["rem"], tc["rem"]
    assert sorted(jcache) == sorted(tcache) == ["0:local", "1:global", "2:local"][
        : (2 if n_layers == 4 else 3)]
    for key in jcache:
        assert torch.equal(tcache[key]["pos"],
                           torch.from_numpy(np.array(jcache[key]["pos"])))
        for f in ("k", "v"):
            assert tcache[key][f].shape == jcache[key][f].shape
            want = _np(jcache[key][f])
            np.testing.assert_allclose(
                _np(tcache[key][f]), want, rtol=0,
                atol=atol * max(1.0, float(np.abs(want).max())))

    for t in range(N_DEC):
        pos = S + t
        jl, jc = j_decode(jp, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.full((B,), pos, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, pos:pos + 1]),
                                    torch.full((B,), pos, dtype=torch.int32), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=atol, rtol=0)


def test_serve_greedy_tokens_match_reference_loop():
    """serve(..., device="cpu") against the reference's prefill + greedy
    decode loop (repro/launch/serve.py) on the same params and prompts."""
    n_new = 6
    jm, jp, tm, tp = _pair(4, "float32")
    prompts = np.random.default_rng(12).integers(0, 256, (B, S))
    j_prefill, j_decode = _jax_steps(jm, S + n_new)
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
    assert len(res["decode_ms"]) == n_new - 1


def test_init_cache_matches_reference():
    jm, _, tm, _ = _pair(4, "bfloat16")
    want = params_from_jax(jax.tree.map(np.asarray, jm.init_cache(B, 40)),
                           tm.cfg, CPU)
    got = tm.init_cache(B, 40, device=CPU)
    for key in ("0:local", "1:global"):
        for g, w in zip(got["scan"][key], want["scan"][key]):
            for f in ("k", "v", "pos"):
                assert g[f].dtype == w[f].dtype and torch.equal(g[f], w[f])
    assert got["scan"]["0:local"][0]["k"].shape == (B, 32, 32)   # ring: window
    assert got["scan"]["1:global"][0]["k"].shape == (B, 40, 32)


def test_short_prompt_ring_keeps_position_zero():
    """A prompt shorter than the window: decode after prefill must equal the
    prefill of the longer sequence (the reference's ring drops position 0
    here, see ROADMAP.md, so this is held against the port itself)."""
    cfg = dataclasses.replace(get_config("gemma2-27b").smoke(), n_layers=4,
                              compute_dtype="float32")
    m = Model(cfg)
    p = m.init(seed=3, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(13).integers(0, 256, (B, 11)))
    with torch.inference_mode():
        full, full_cache = m.prefill(p, toks)
        # no decode headroom: the cache must still be writable in place
        assert full_cache["scan"]["1:global"][0]["pos"].is_contiguous()
        _, cache = m.prefill(p, toks[:, :10], max_len=16)
        ring = cache["scan"]["0:local"][0]["pos"]
        assert ring.shape == (B, cfg.attn_window)
        assert ring[:, :10].tolist() == [list(range(10))] * B
        dec, _ = m.decode_step(p, toks[:, 10:], torch.full((B,), 10,
                                                           dtype=torch.int32),
                               cache)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=1e-5, rtol=0)
