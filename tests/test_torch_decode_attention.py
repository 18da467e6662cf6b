"""Decode attention's dispatch, its kernel's wrapper and the pieces of the
kernel that are plain Python, on the CPU: a CPU tensor runs the plain
version, bit for bit what ``models/attention.py`` computed before the kernel
existed; a meta tensor (the dry run) gets the output's shape and the
kernel's cost without a launch; ``check_inputs`` refuses what the kernel
does not take; the per-row slot bound drops no slot the plain mask keeps,
on caches written as the program writes them; the split of the slot axis
covers it. The kernel against the plain version on the card:
``tests/test_torch_cuda.py``.

Tolerances: the dispatch, the bound and the counts are equal; the plain
version over the bound's slots alone equals it over every slot within 1e-6
of max|v| in the output and 1e-6 (absolute and relative) in the max (f32:
the same terms, summed by products of another shape)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.decode_attention import kernel, ref  # noqa: E402
from repro_torch.kernels.decode_attention.cost import decode_cost  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.launch.mesh import AxisGroup  # noqa: E402
from repro_torch.models import attention, kvcache  # noqa: E402


def _decode_attention_before(q, k_cache, v_cache, *, pos, cache_positions,
                             scale, cap, window=0, group=None):
    """``models/attention.py::decode_attention`` as it stood before the
    kernel, verbatim but for the softcap's import (``layers.softcap``)."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bthd->bhgt", qg.float(), k_cache.float())
    s = s * scale
    s = torch.tanh(s / cap) * cap if cap else s
    valid = (cache_positions >= 0) & (cache_positions <= pos[:, None])
    if window:
        valid &= (pos[:, None] - cache_positions) < window
    s = torch.where(valid[:, None, None, :], s, -2.0e38)
    if group is None:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype), v_cache)
        return o.reshape(B, 1, Hq, D)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    part = torch.cat([m, p.sum(-1, keepdim=True),
                      torch.einsum("bhgt,bthd->bhgd", p, v_cache.float())], -1)
    parts = torch.stack(group.all_gather(part))
    m_all, l_all, o_all = parts[..., :1], parts[..., 1:2], parts[..., 2:]
    w = torch.exp(m_all - m_all.amax(0))
    o = (w * o_all).sum(0) / (w * l_all).sum(0).clamp_min(1e-30)
    return o.to(v_cache.dtype).reshape(B, 1, Hq, D)


def _written_positions(pos: list[int], T: int) -> torch.Tensor:
    """(B, T) int32: the positions a cache of T slots holds after a row wrote
    0, 1, ..., pos_b one at a time at slot p % T."""
    t = torch.arange(T)
    rows = []
    for p in pos:
        held = p - (p - t) % T
        rows.append(torch.where(t <= p, held, torch.full_like(t, -1)))
    return torch.stack(rows).to(torch.int32)


def _none_valid(part: torch.Tensor) -> bool:
    """Whether a partial's every m is the mask value (f32 -2e38)."""
    return bool((part[..., 0] == torch.tensor(ref.NEG_INF)).all())


def _inputs(B, T, Hq, Hkv, D, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 1, Hq, D), generator=g).to(dtype)
    k = torch.randn((B, T, Hkv, D), generator=g).to(dtype)
    v = torch.randn((B, T, Hkv, D), generator=g).to(dtype)
    return q, k, v


# -- (a) the dispatch ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(Hq=8, Hkv=2, D=16, T=40, pos=[5, 39, 90], cap=0.0, window=0),
    dict(Hq=4, Hkv=4, D=32, T=24, pos=[0, 23, 50], cap=50.0, window=0),
    dict(Hq=6, Hkv=1, D=16, T=16, pos=[3, 15, 40], cap=30.0, window=16),
    dict(Hq=4, Hkv=2, D=64, T=64, pos=[63, 10, 200], cap=0.0, window=20),
], ids=["gqa", "cap", "ring", "window"])
@pytest.mark.parametrize("grouped", [False, True])
def test_cpu_dispatch_is_the_plain_version_bit_for_bit(dtype, case, grouped):
    """A CPU tensor runs the plain version: the same bits as before the
    kernel, with or without a (one-rank) sequence group, and no launch."""
    B = len(case["pos"])
    q, k, v = _inputs(B, case["T"], case["Hq"], case["Hkv"], case["D"], dtype)
    kw = dict(pos=torch.tensor(case["pos"], dtype=torch.int32),
              cache_positions=_written_positions(case["pos"], case["T"]),
              scale=case["D"] ** -0.5, cap=case["cap"], window=case["window"],
              group=AxisGroup([0], 0, None) if grouped else None)
    before = dict(LAUNCHES)
    got = attention.decode_attention(q, k, v, **kw)
    want = _decode_attention_before(q, k, v, **kw)
    assert dict(LAUNCHES) == before
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_plain_combine_of_two_ranks_is_the_whole_cache():
    """The plain partials of a cache's two halves (``decode_partial``),
    combined, give the plain version over the whole cache, a half with no
    valid slot included."""
    B, T, Hq, Hkv, D = 3, 32, 4, 2, 16
    q, k, v = _inputs(B, T, Hq, Hkv, D)
    pos = [5, 20, 31]                   # row 0 sees nothing of the 2nd half
    cp = _written_positions(pos, T)
    kw = dict(pos=torch.tensor(pos, dtype=torch.int32), scale=0.25, cap=0.0)
    parts = [ref.decode_partial(q, k[:, r * 16:(r + 1) * 16], v[:, r * 16:(r + 1) * 16],
                                cache_positions=cp[:, r * 16:(r + 1) * 16], **kw)
             for r in (0, 1)]
    assert _none_valid(parts[1][0])
    got = ref.combine(parts, v.dtype)
    want = ref.decode_attention(q, k, v, cache_positions=cp, **kw)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)


# -- (b) the meta wrapper --------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128), (torch.float32, 16)])
def test_kernel_wrapper_on_meta_counts_its_formula(partial, dtype, D):
    """On meta the wrapper returns the output's shape (the partial's with
    ``partial``) and counts 4·B·Hq·D·T operations and the caches' bytes
    once; nothing launches."""
    B, T, Hq, Hkv = 3, 100, 16, 2
    args = (_meta(B, 1, Hq, D, dtype=dtype), _meta(B, T, Hkv, D, dtype=dtype),
            _meta(B, T, Hkv, D, dtype=dtype), _meta(B, dtype=torch.int32),
            _meta(B, T, dtype=torch.int32))
    before = dict(LAUNCHES)
    o, rep = op_analysis.analyze(
        lambda q, k, v, p, c: kernel.decode_attention(
            q, k, v, pos=p, cache_positions=c, scale=0.1, cap=0.0,
            seq_index=1 if partial else 0, partial=partial), *args)
    want = decode_cost(B, T, Hq, Hkv, D, dtype.itemsize)
    assert dict(LAUNCHES) == before
    assert o.device.type == "meta"
    assert tuple(o.shape) == ((B, Hkv, Hq // Hkv, D + 2) if partial else (B, 1, Hq, D))
    assert o.dtype == (torch.float32 if partial else dtype)
    assert rep["kernels"]["decode_attention"] == {"calls": 1, **want}
    assert want["flops"] == 4 * B * Hq * D * T
    assert want["bytes"] == (2 * B * T * Hkv * D + 2 * B * Hq * D) * dtype.itemsize + 4 * B * T


def test_meta_decode_attention_takes_the_kernels_path():
    """``models.attention.decode_attention`` on meta is the kernel's meta
    path: its formula, not the plain version's einsums."""
    B, T, Hq, Hkv, D = 2, 64, 8, 2, 64
    args = (_meta(B, 1, Hq, D), _meta(B, T, Hkv, D), _meta(B, T, Hkv, D),
            _meta(B, dtype=torch.int32), _meta(B, T, dtype=torch.int32))
    o, rep = op_analysis.analyze(
        lambda q, k, v, p, c: attention.decode_attention(
            q, k, v, pos=p, cache_positions=c, scale=0.1, cap=50.0), *args)
    assert tuple(o.shape) == (B, 1, Hq, D)
    assert rep["kernels"] == {"decode_attention": {
        "calls": 1, **decode_cost(B, T, Hq, Hkv, D, 4)}}


# -- (c) check_inputs ----------------------------------------------------------


def _good(dtype=torch.bfloat16, D=128, B=2, T=64, Hq=8, Hkv=2):
    return dict(q=_meta(B, 1, Hq, D, dtype=dtype), k_cache=_meta(B, T, Hkv, D, dtype=dtype),
                v_cache=_meta(B, T, Hkv, D, dtype=dtype), pos=_meta(B, dtype=torch.int32),
                cache_positions=_meta(B, T, dtype=torch.int32))


def _with(**over):
    args = _good()
    args.update(over)
    return args


REFUSED = {
    "q not 4-d": _with(q=_meta(2, 8, 128, dtype=torch.bfloat16)),
    "v shape": _with(v_cache=_meta(2, 63, 2, 128, dtype=torch.bfloat16)),
    "two query tokens": _with(q=_meta(2, 2, 8, 128, dtype=torch.bfloat16)),
    "batch": _with(q=_meta(3, 1, 8, 128, dtype=torch.bfloat16)),
    "heads not grouped": _with(q=_meta(2, 1, 7, 128, dtype=torch.bfloat16)),
    "head dims differ": _with(q=_meta(2, 1, 8, 64, dtype=torch.bfloat16)),
    "empty cache": _good(T=0),
    "float16": _good(dtype=torch.float16),
    "mixed dtypes": _with(q=_meta(2, 1, 8, 128, dtype=torch.float32)),
    "head dim 48": _good(D=48),
    "head dim strided": _with(k_cache=_meta(2, 64, 2, 256, dtype=torch.bfloat16)[..., ::2]),
    "pos shape": _with(pos=_meta(2, 1, dtype=torch.int32)),
    "pos float": _with(pos=_meta(2, dtype=torch.float32)),
    "positions int64": _with(cache_positions=_meta(2, 64, dtype=torch.int64)),
    "positions shape": _with(cache_positions=_meta(2, 63, dtype=torch.int32)),
    "positions strided": _with(cache_positions=_meta(2, 128, dtype=torch.int32)[:, ::2]),
    "cache stride off 16 bytes": _with(
        k_cache=_meta(2, 64, 2, 132, dtype=torch.bfloat16)[..., :128]),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_check_inputs_refuses(name):
    with pytest.raises(ValueError):
        kernel.check_inputs(**REFUSED[name], cap=0.0, window=0)


@pytest.mark.parametrize("opts", [dict(window=-1), dict(cap=-1.0), dict(seq_index=-1)])
def test_check_inputs_refuses_options(opts):
    kw = dict(cap=0.0, window=0, seq_index=0)
    kw.update(opts)
    with pytest.raises(ValueError):
        kernel.check_inputs(**_good(), **kw)


def test_check_inputs_takes_what_the_program_passes():
    """The program's shapes: the flat cache's (B, T, Hkv, D) view, int32 or
    int64 pos, every instance; a CPU tensor is refused by the launcher."""
    for dtype in (torch.float32, torch.bfloat16):
        for D in kernel.HEAD_DIMS:
            kernel.check_inputs(**_good(dtype=dtype, D=D), cap=50.0, window=4096)
    flat = _meta(2, 64, 2 * 128, dtype=torch.bfloat16).reshape(2, 64, 2, 128)
    kernel.check_inputs(**_with(k_cache=flat, v_cache=flat,
                                pos=_meta(2, dtype=torch.int64)), cap=0.0, window=0)
    cpu = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in _good().items()}
    with pytest.raises(ValueError):
        kernel.decode_attention(**cpu, scale=0.1, cap=0.0)


# -- (d) the slot bound --------------------------------------------------------


def _insert_all(B, T, Hkv, D, steps, *, window=0, seq=None, prompt=4, seed=0):
    """A cache built as the program builds it: a prefill of ``prompt``
    tokens (positions 0..prompt-1), then ``steps`` one-token inserts, each
    row at its own pace (row b stops after steps[b] of them). Returns the
    cache and each row's last position."""
    g = torch.Generator().manual_seed(seed)
    kv = lambda S: torch.randn((B, S, Hkv, D), generator=g)  # noqa: E731
    positions = torch.arange(prompt, dtype=torch.int32)[None].expand(B, prompt)
    cache = kvcache.cache_from_prefill(kv(prompt), kv(prompt), positions,
                                       window=window, max_len=T, seq=seq)
    pos = torch.full((B,), prompt - 1, dtype=torch.int32)
    for i in range(max(steps)):
        rows = torch.tensor([i < s for s in steps])
        nxt = torch.where(rows, pos + 1, pos)
        k1, v1 = kv(1), kv(1)
        snap = {n: t.clone() for n, t in cache.items()}
        kvcache.cache_insert(cache, k1, v1, nxt, seq)
        for n in cache:          # rows that stopped keep what they held
            cache[n][~rows] = snap[n][~rows]
        pos = nxt
    return cache, pos


CACHES = {
    "global, short": dict(T=48, window=0, seq=None, steps=[0, 10, 44]),
    "global, wrapped (pos >= T)": dict(T=24, window=0, seq=None, steps=[30, 60, 5]),
    "ring with wrap": dict(T=16, window=16, seq=None, steps=[3, 20, 50]),
    "pos 0": dict(T=32, window=0, seq=None, steps=[0, 0, 1], prompt=1),
    "seq rank 0 of 2": dict(T=16, window=0, seq=(0, 2), steps=[2, 20, 40]),
    "seq rank 1 of 2": dict(T=16, window=0, seq=(1, 2), steps=[2, 20, 40]),
    "seq rank 2 of 3, wrapped": dict(T=24, window=0, seq=(2, 3), steps=[5, 18, 30]),
}


@pytest.mark.parametrize("name", list(CACHES))
def test_slot_bound_drops_no_visible_slot(name):
    """Every slot at or past a row's bound is invalid under the plain mask,
    and the plain version over the bound's slots alone equals it over every
    slot (the partial where the cache is one rank's)."""
    c = CACHES[name]
    B, Hq, Hkv, D = 3, 4, 2, 16
    cache, pos = _insert_all(B, c["T"], Hkv, D, c["steps"], window=c["window"],
                             seq=c["seq"], prompt=c.get("prompt", 4))
    T = cache["k"].shape[1]
    index = c["seq"][0] if c["seq"] else 0
    nb = ref.slot_bound(pos, T, index)
    want_nb = (pos.long() + 1 - index * T).clamp(0, T)
    assert torch.equal(nb, want_nb)
    cp = cache["pos"]
    valid = (cp >= 0) & (cp <= pos[:, None])
    if c["window"]:
        valid &= (pos[:, None] - cp) < c["window"]
    past = torch.arange(T)[None, :] >= nb[:, None]
    assert not bool((valid & past).any())
    assert bool(valid.any(1)[nb > 0].all()) or c["seq"]
    q = torch.randn((B, 1, Hq, D), generator=torch.Generator().manual_seed(1))
    k = cache["k"].reshape(B, T, Hkv, D)
    v = cache["v"].reshape(B, T, Hkv, D)
    kw = dict(pos=pos, scale=0.25, cap=0.0, window=c["window"])
    for b in range(B):
        n = int(nb[b])
        sl = lambda t: t[b:b + 1, :n]  # noqa: E731
        whole = ref.decode_partial(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   cache_positions=cp[b:b + 1], **{**kw, "pos": pos[b:b + 1]})
        if n == 0:
            assert _none_valid(whole)                      # nothing valid here
            continue
        cut = ref.decode_partial(q[b:b + 1], sl(k), sl(v), cache_positions=sl(cp),
                                 **{**kw, "pos": pos[b:b + 1]})
        if _none_valid(whole):
            assert _none_valid(cut)
            continue
        assert torch.allclose(cut[..., 0], whole[..., 0], rtol=1e-6, atol=1e-6)
        o_cut = cut[..., 2:] / cut[..., 1:2]
        o_whole = whole[..., 2:] / whole[..., 1:2]
        assert torch.allclose(o_cut, o_whole, rtol=0, atol=1e-6 * float(v.abs().max()))


# -- the split of the slot axis ----------------------------------------------------


@pytest.mark.parametrize("B,T,Hkv,G,bps,want", [
    (256, 2304, 8, 8, 2, (1, 2304)), (1, 32768, 8, 8, 2, (64, 512)),
    (4, 40, 2, 2, 8, (1, 64)), (1, 4096, 1, 48, 1, (32, 128)),
    (32, 8192, 16, 2, 4, (3, 2752)), (1, 64, 1, 1, 8, (1, 64)),
    (7, 1000, 3, 5, 3, (16, 64)), (65535, 100, 1, 1, 2, (1, 128)),
    (512, 131072, 8, 8, 2, (16, 8192))])
def test_plan_covers_the_slots_in_rounds(B, T, Hkv, G, bps, want):
    """The splits cover every slot in chunks of whole rounds (64 slots), no
    split empty, no chunk past MAX_CHUNK; a grid short of two waves of
    blocks takes more splits, down to one round a block."""
    splits, chunk = kernel.plan(B, T, Hkv, G, 132, bps)
    assert (splits, chunk) == want
    assert chunk % kernel.ROUND == 0 and splits * chunk >= T > (splits - 1) * chunk
    assert chunk <= kernel.MAX_CHUNK
