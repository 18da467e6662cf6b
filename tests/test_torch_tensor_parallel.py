"""Port parity for serving on a (data, model) mesh: tensor and expert
parallelism in every layer kind and the sequence-sharded KV-cache decode
(``repro_torch/train/sharding.py``'s ``local_slice``, ``shard_tree`` and
``TPContext``, the sharded layers, ``train/serve_step.py``, and
``launch/serve.py --mesh``). Ranks are gloo processes on the CPU
(``launch.spawn.run_ranks``; the rank functions are in
``tests/_torch_dist.py``), the checks of one mesh in one call.

Each serving check holds the port's sharded prefill and greedy decode
against the reference's one-device ``Model.prefill``/``decode_step`` on
the same converted params (biases and q/k norm scales drawn at random so
that they bind), in f32: every logit within 1e-4 of the largest |logit|
(the reference's own gate for its SP decode check,
``tests/distributed_checks.py::check_seq_sharded_decode``; the sharded sums
round otherwise than one device's), and the greedy tokens equal. The
shards of every leaf, put back together, and a rank's sharded init against
the one-device init's share: bit for bit.
"""
import dataclasses
import functools
import inspect
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_dist  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import to_reference_layout  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.transformer import transformer_specs  # noqa: E402
from repro_torch.train.sharding import (head_plan, local_slice,  # noqa: E402
                                        make_rules, take)

REL = 1e-4
S, N_DEC = 40, 4
F32 = {"compute_dtype": "float32"}
# the layer kinds: mamba (the scan on di/2), RG-LRU with MQA local
# attention, MoE (EP) with a shared expert, MQA with the prefix-LM prefix,
# and local/global attention with both softcaps
KINDS = ["falcon-mamba-7b", "recurrentgemma-9b", "llama4-maverick-400b-a17b",
         "paligemma-3b", "gemma2-27b"]
BIND = ("bq", "bk", "bv", "q_norm", "k_norm", "b_i", "b_r", "conv_b")
# arctic's smoke at 6 query heads over 2 KV heads, padded to 8: a model
# axis of 4 divides only the padded heads
PADDED = {"n_heads": 6, "n_kv_heads": 2, "pad_heads_to": 8}


def _reference_tree(arch, cfg_kw=()):
    """The reference's init of the smoke config as numpy, the leaves named
    in BIND drawn at random."""
    rng = np.random.default_rng(17)

    def bind(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1].key in BIND:
            leaf = (1.0 * path[-1].key.endswith("norm")
                    + 0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    cfg = dataclasses.replace(jax_config(arch).smoke(), **dict(cfg_kw))
    return jax.tree_util.tree_map_with_path(
        bind, JaxModel(cfg).init(jax.random.PRNGKey(0)))


def _reference_serve(arch, cfg_kw, tree, prompts, n_dec):
    """The reference on one device: prefill and ``n_dec`` greedy steps.
    Returns the logits (B, n_dec + 1, V) and tokens (B, n_dec + 1)."""
    jm = JaxModel(dataclasses.replace(jax_config(arch).smoke(), **cfg_kw))
    jp = jax.tree.map(jnp.asarray, tree)
    B, S_ = prompts.shape
    lg, cache = jax.jit(functools.partial(jm.prefill, rules={},
                                          max_len=S_ + n_dec))(jp, jnp.asarray(prompts))
    decode = jax.jit(functools.partial(jm.decode_step, rules={}))
    logits, tokens = [], []
    for i in range(n_dec + 1):
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1)[:, None]
        tokens.append(np.asarray(tok))
        if i < n_dec:
            lg, cache = decode(jp, tok, jnp.full((B,), S_ + i, jnp.int32), cache)
    return np.stack(logits, 1), np.concatenate(tokens, 1)


def _job(arch, B, cfg_kw=F32, n_dec=N_DEC, seq_len=S, **kw):
    prompts = np.random.default_rng(11).integers(0, 256, (B, seq_len))
    return {"arch": arch, "cfg_kw": dict(cfg_kw), "prompts": prompts,
            "n_dec": n_dec, "tree": _reference_tree(arch, cfg_kw), **kw}


def _hold(job, got):
    want_lg, want_tok = _reference_serve(job["arch"], job["cfg_kw"], job["tree"],
                                         job["prompts"], job["n_dec"])
    for r, res in enumerate(got):
        err = np.abs(res["logits"] - want_lg).max() / np.abs(want_lg).max()
        assert err < REL, (job["arch"], r, err)
        np.testing.assert_array_equal(res["tokens"], want_tok)


def _fake_mesh(shape, coords):
    axes = ("data", "model")
    return types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes,
                                 coords=dict(zip(axes, coords)))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def at_1x2():
    """The five layer kinds on one 1x2 run, B 2, shards and init kept."""
    jobs = [_job(a, 2, shards=True) for a in KINDS]
    return jobs, run_ranks(_torch_dist.serve_jobs, 2, (1, 2), jobs)


@pytest.mark.parametrize("arch", KINDS)
def test_layer_kind_on_1x2_matches_reference(arch, at_1x2):
    jobs, got = at_1x2
    i = KINDS.index(arch)
    _hold(jobs[i], [g[i] for g in got])


@pytest.mark.parametrize("arch", KINDS)
def test_shards_put_back_together_are_the_whole_tree(arch, at_1x2):
    """Every leaf's shards, placed by their cuts, cover it once (a leaf
    kept whole, or KV heads shared, on both ranks with the same bits) and
    give it bit for bit; ``wq`` is cut on whole heads and mamba's
    ``in_proj`` on the channels of x and of z alike. A rank's sharded init
    is its share of the one-device init, bit for bit."""
    jobs, got = at_1x2
    i = KINDS.index(arch)
    cfg = dataclasses.replace(get_config(arch).smoke(), **F32)
    specs = transformer_specs(cfg)
    fakes = [_fake_mesh((1, 2), (0, r)) for r in range(2)]
    rules = make_rules(fakes[0], cfg)
    whole_init = to_reference_layout(Model(cfg).init(seed=3, device="cpu"))
    n_cut = 0
    for path, whole in _leaves(jobs[i]["tree"]):
        spec = _get(specs, path)
        back = np.zeros_like(whole)
        seen = np.zeros(whole.shape, np.int64)
        for r in range(2):
            cuts = local_slice(spec, fakes[r], rules, cfg)
            shard = _get(got[r][i]["shard"], path)
            init = _get(got[r][i]["init"], path)
            want_init = take(_get(whole_init, path), cuts)
            assert init.tobytes() == np.ascontiguousarray(want_init).tobytes(), path
            idx = np.ix_(*[np.concatenate([np.arange(a, b) for a, b in c])
                           for c in cuts])
            assert np.all((seen[idx] == 0) | (back[idx] == shard)), path
            back[idx], seen[idx] = shard, seen[idx] + 1
            n_cut += shard.shape != whole.shape
        assert seen.min() >= 1 and back.tobytes() == whole.tobytes(), path
        if path[-1] == "wq":
            D = cfg.head_dim
            assert all(a % D == 0 and b % D == 0
                       for r in range(2)
                       for a, b in local_slice(spec, fakes[r], rules, cfg)[-1])
        if path[-1] == "in_proj":
            di = cfg.d_inner
            for r in range(2):
                x_r = whole[..., r * di // 2:(r + 1) * di // 2]
                z_r = whole[..., di + r * di // 2:di + (r + 1) * di // 2]
                np.testing.assert_array_equal(_get(got[r][i]["shard"], path),
                                              np.concatenate([x_r, z_r], -1))
    assert n_cut > 0


def test_dp_rows_and_tp_at_2x2_match_reference():
    """gemma2-27b at 2x2, B 4: two rows a DP rank, heads, MLP and vocab
    over model; each rank's caches hold its rows and its KV head. And
    llama4's MoE there: decode routes the whole batch as one group, as the
    reference does, so the DP ranks' tokens meet before the routing."""
    jobs = [_job("gemma2-27b", 4), _job("llama4-maverick-400b-a17b", 4)]
    got = run_ranks(_torch_dist.serve_jobs, 4, (2, 2), jobs)
    for i, job in enumerate(jobs):
        _hold(job, [g[i] for g in got])
    cfg = get_config("gemma2-27b").smoke()
    for g in got:
        B_local, F_local = 2, cfg.n_kv_heads * cfg.head_dim // 2
        assert g[0]["init_cache_shapes"] == g[0]["cache_shapes"]
        assert all(s[0] == B_local for s in g[0]["cache_shapes"])
        assert (B_local, S + N_DEC, F_local) in g[0]["cache_shapes"]


def test_seq_sharded_decode_at_4x2_matches_reference():
    """The twin of the reference's ``check_seq_sharded_decode``: gemma3-4b
    smoke in f32, B 1, S 64, max_len 72, mesh 4x2 with ``seq_shard_kv``:
    each data rank holds 18 of the global caches' 72 slots and its KV
    head; the local rings stay whole. Prefill and 8 decode steps."""
    job = _job("gemma3-4b", 1, n_dec=8, seq_len=64, seq_shard_kv=True)
    got = run_ranks(_torch_dist.serve_jobs, 8, (4, 2), [job])
    _hold(job, [g[0] for g in got])
    cfg = get_config("gemma3-4b").smoke()
    F_local = cfg.n_kv_heads * cfg.head_dim // 2
    for g in got:
        shapes = g[0]["cache_shapes"]
        assert g[0]["init_cache_shapes"] == shapes
        assert (1, 18, F_local) in shapes and (1, cfg.attn_window, F_local) in shapes
        assert not any(s[1] == 72 for s in shapes if len(s) == 3)


def test_padded_heads_are_exact():
    """The twin of the reference's ``test_padded_mha_is_exact``: the same
    params with and without ``pad_heads_to``, identical logits."""
    base = dataclasses.replace(get_config("arctic-480b").smoke(), **F32,
                               n_heads=6, n_kv_heads=2)
    padded = dataclasses.replace(base, pad_heads_to=8)
    params = Model(base).init(seed=4, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 40)))
    with torch.inference_mode():
        lg0, _ = Model(base).prefill(params, toks)
        lg1, _ = Model(padded).prefill(params, toks)
    assert torch.equal(lg0, lg1)


def test_model_axis_dividing_only_the_padded_heads():
    """Mesh 1x4 over 6 query heads padded to 8 (Gp 4 a KV group): ranks
    own padded heads {0,1}, {2,3}, {4,5}, {6,7}, so real heads 0-1, 2,
    3-4, 5, each reading its KV head; against the reference's one-device
    prefill and decode (its padded-MHA layout). Without the padding the
    axis divides no head count: the heads are split mid-head (no plan;
    every rank gathers q, k, v and computes every head, as GSPMD cuts the
    reference's flat projections), which serves the same logits; where
    the axis does not divide the flat projections either, it raises."""
    cfg = dataclasses.replace(get_config("arctic-480b").smoke(), **PADDED)
    assert [head_plan(cfg, 4, r) for r in range(4)] == [
        (0, 2, 0, 1), (2, 3, 0, 1), (3, 5, 1, 2), (5, 6, 1, 2)]
    unpadded = dataclasses.replace(cfg, pad_heads_to=0)
    assert head_plan(unpadded, 4, 0) is None
    with pytest.raises(ValueError, match="divides neither"):
        head_plan(unpadded, 5, 0)
    jobs = [_job("arctic-480b", 2, cfg_kw={**F32, **PADDED}),
            _job("arctic-480b", 2, cfg_kw={**F32, **PADDED, "pad_heads_to": 0})]
    got = run_ranks(_torch_dist.serve_jobs, 4, (1, 4), jobs)
    for i, job in enumerate(jobs):
        _hold(job, [g[i] for g in got])


def test_serve_on_a_mesh_gives_the_one_device_tokens():
    """``serve`` at 2x2 on the CPU: rank 0's tokens and prefill logits are
    the one-device serve's (f32, params from the same seed: each rank
    draws its shard of the one-device init)."""
    from repro_torch.launch.serve import serve
    cfg = dataclasses.replace(get_config("gemma2-27b").smoke(), **F32)
    kw = dict(batch=4, prompt_len=24, new_tokens=6, device="cpu",
              log=lambda m: None)
    one = serve(cfg, **kw)
    got = serve(cfg, mesh="2x2", keep_logits=True, **kw)
    assert torch.equal(got["tokens"], one["tokens"])
    lg = one["prefill_logits"]
    assert float((got["prefill_logits"] - lg).abs().max()) < REL * float(lg.abs().max())
    assert got["step_logits"].shape == (4, 5, cfg.vocab_size)
    assert len(got["launches_by_rank"]) == 4


def test_serve_cli_on_four_ranks(capfd):
    """``python -m repro_torch.launch.serve --arch gemma2-27b --smoke --mesh
    2x2 --device cpu`` with the decode latencies staged in transit: it runs
    to its end on four ranks, rank 0 alone prints, and SAVIME holds every
    decode step's latency."""
    from repro_torch.launch.serve import main
    out = main(["--arch", "gemma2-27b", "--smoke", "--mesh", "2x2", "--device",
                "cpu", "--new-tokens", "8", "--intransit", "--analyzer",
                "running_stats"])
    printed = capfd.readouterr().out
    assert out["tokens"].shape == (4, 8)
    assert printed.count("[serve] sample (req 0)") == 1
    assert printed.count("mesh {'data': 2, 'model': 2}") == 1
    assert "'count': 7" in printed


def test_mesh_strings_read_as_the_train_launcher_reads_them(monkeypatch):
    """``PxDxM`` is (pod, data, model) in the port's serve, as in both
    train launchers. The reference's serve passes the parts to
    ``make_debug_mesh(data, model, pod)`` in order, so there ``2x2x1``
    serves on pod 1, data 2, model 2 (ROADMAP, reference caveats)."""
    from repro.launch import mesh as jax_mesh
    from repro.launch import serve as jax_serve
    assert mesh_mod.parse_mesh("2x2x1") == ((2, 2, 1), ("pod", "data", "model"))
    assert mesh_mod.parse_mesh("4x2") == ((4, 2), ("data", "model"))
    seen = {}
    monkeypatch.setattr(jax_serve, "make_debug_mesh",
                        lambda *a: seen.setdefault("args", a))
    jax_serve.build_mesh("2x2x1")
    names = list(inspect.signature(jax_mesh.make_debug_mesh).parameters)
    assert dict(zip(names, seen["args"])) == {"data": 2, "model": 2, "pod": 1}
