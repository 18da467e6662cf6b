"""Port parity: the plain version of the flash-attention kernel
(repro_torch.kernels.flash_attention) against the reference's Pallas kernel
run in interpret mode and against its dense oracle.

Tolerances are the reference's own (tests/test_kernels.py): 2e-6 for f32,
2e-2 for bf16. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py); here a torch emulation of its
bf16 rounding is held to ``ref.kernel_error_limit``, the limit the card
holds the kernel to, and the mask probe (an input whose answer is exact) is
shown to catch a mask that is one key off. The prefix-LM mask (``prefix``,
which the Pallas kernel lacks) is held against the reference model's
``make_mask_fn`` through its ``flash_attention_xla``, at the same f32/bf16
tolerances, and at head dim 256.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.models.attention import flash_attention_xla, make_mask_fn  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

TOL = {"float32": 2e-6, "bfloat16": 2e-2}
CPU = torch.device("cpu")

REF_CASES = [  # tests/test_kernels.py:101-106
    dict(B=2, S=256, Hq=4, Hkv=2, D=64, window=0, cap=0.0, causal=True),
    dict(B=1, S=512, Hq=8, Hkv=1, D=128, window=0, cap=50.0, causal=True),
    dict(B=2, S=256, Hq=4, Hkv=4, D=64, window=128, cap=0.0, causal=True),
    dict(B=1, S=256, Hq=2, Hkv=2, D=64, window=0, cap=0.0, causal=False),
]


def _inputs(shapes, dtype, seed):
    """numpy-seeded inputs as (jax arrays, torch tensors) with equal bits."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s).astype(np.float32), dtype)
          for s in shapes]
    return js, [tensor_from_numpy(np.asarray(j), CPU) for j in js]


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("cfg", REF_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_oracle(cfg, dtype):
    B, S, Hq, Hkv, D = cfg["B"], cfg["S"], cfg["Hq"], cfg["Hkv"], cfg["D"]
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], getattr(jnp, dtype), 2)
    kw = dict(softcap=cfg["cap"], causal=cfg["causal"], window=cfg["window"])
    before = LAUNCHES["flash_attention"]
    o = ops.gqa_attention(q, k, v, **kw)
    assert LAUNCHES["flash_attention"] == before   # CPU: the plain version
    assert o.shape == (B, S, Hq, D) and o.dtype == q.dtype
    _close(o, jops.gqa_attention(jq, jk, jv, impl="pallas", block_q=128,
                                 block_k=128, interpret=True, **kw), dtype)
    _close(o, jops.gqa_attention_ref(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (37, 50.0)])
def test_plain_matches_oracle_ragged(groups, dtype, window, cap):
    """S = 100 is no multiple of any tile; the Pallas kernel needs one, so
    the oracle is the reference's dense attention."""
    B, S, Hkv, D = 2, 100, 2, 16
    Hq = Hkv * groups
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], getattr(jnp, dtype),
        groups)
    kw = dict(scale=0.3, softcap=cap, causal=True, window=window)
    _close(ops.gqa_attention(q, k, v, **kw),
           jops.gqa_attention_ref(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_oracle_when_sq_differs_from_sk(causal):
    """Head-major layout as the reference kernel takes it; Sk > Sq is the
    case the reference wrapper's block choice (block_k from Sq) gets wrong."""
    (jq, jk, jv), (q, k, v) = _inputs([(6, 40, 16), (3, 72, 16), (3, 72, 16)],
                                      jnp.float32, 9)
    kw = dict(groups=2, scale=0.25, softcap=30.0, causal=causal, window=0)
    _close(ref.attention_ref(q, k, v, **kw), jref.attention_ref(jq, jk, jv, **kw),
           "float32")


def test_plain_chunking_does_not_change_the_result(monkeypatch):
    _, (q, k, v) = _inputs([(8, 50, 16), (2, 50, 16), (2, 50, 16)],
                           jnp.float32, 4)
    kw = dict(groups=4, scale=0.25, softcap=50.0, causal=True, window=9)
    whole = ref.attention_ref(q, k, v, **kw)
    monkeypatch.setattr(ref, "_MAX_SCORE_ELEMS", 3 * 50 * 50)  # 3 rows a chunk
    assert torch.equal(ref.attention_ref(q, k, v, **kw), whole)


@pytest.mark.parametrize("D", [16, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prefix", [1, 17, 40, 64])
def test_plain_prefix_matches_reference_mask(D, dtype, prefix):
    """The prefix-LM mask against the reference model's: make_mask_fn(
    causal, prefix) through flash_attention_xla (its non-local prefill),
    chunks of 16 so that the prefix crosses chunks; MQA, GQA 4. prefix 64
    > S: every key is visible."""
    B, S, Hkv, G = 2, 50, 1, 4
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, S, Hkv * G, D), (B, S, Hkv, D), (B, S, Hkv, D)],
        getattr(jnp, dtype), prefix)
    want = flash_attention_xla(
        jq.reshape(B, S, Hkv, G, D), jk, jv,
        mask_fn=make_mask_fn(causal=True, window=0, prefix=prefix),
        scale=D ** -0.5, cap=50.0, chunk_q=16, chunk_k=16)
    got = ops.gqa_attention(q, k, v, softcap=50.0, causal=True, prefix=prefix)
    _close(got, want.reshape(B, S, Hkv * G, D), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_at_head_dim_256(dtype):
    """Head dim 256 (gemma3, paligemma, recurrentgemma), causal and under a
    window, against the reference's Pallas kernel in interpret mode."""
    B, S, Hq, Hkv, D = 1, 256, 2, 1, 256
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], getattr(jnp, dtype), 3)
    for window in (0, 100):
        kw = dict(softcap=0.0, causal=True, window=window)
        _close(ops.gqa_attention(q, k, v, **kw),
               jops.gqa_attention(jq, jk, jv, impl="pallas", block_q=128,
                                  block_k=128, interpret=True, **kw), dtype)


def test_prefix_never_comes_with_a_window():
    """The reference gives local layers no prefix; the kernel's checks and
    the plain version both refuse the combination instead of composing it."""
    q = torch.zeros(1, 8, 4, 256)
    kv = torch.zeros(1, 8, 1, 256)
    kernel.check_inputs(q, kv, kv, causal=True, window=0, prefix=4)
    kernel.check_inputs(q, kv, kv, causal=True, window=4, prefix=0)
    with pytest.raises(ValueError, match="window"):
        kernel.check_inputs(q, kv, kv, causal=True, window=4, prefix=4)
    with pytest.raises(ValueError, match="prefix"):
        kernel.check_inputs(q, kv, kv, causal=True, window=0, prefix=-1)
    with pytest.raises(ValueError, match="window"):
        ops.gqa_attention(q, kv, kv, window=4, prefix=4)
    with pytest.raises(ValueError, match="window"):
        ref.mask_probe_answer(1, 8, 8, 4, 256, causal=True, window=4, prefix=4)


def test_kernel_rejects_what_it_does_not_take():
    q = torch.zeros(1, 8, 4, 64)
    kv = torch.zeros(1, 8, 2, 64)
    kernel.check_inputs(q, kv, kv, causal=True, window=0)      # accepted
    for d in (16, 32, 128, 256):                                 # head dims
        kernel.check_inputs(torch.zeros(1, 8, 4, d), torch.zeros(1, 8, 2, d),
                            torch.zeros(1, 8, 2, d), causal=True, window=0)
    bad = [
        (torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48)),  # head dim
        (q.double(), kv.double()),                              # dtype
        (q, torch.zeros(1, 8, 3, 64)),                          # Hq % Hkv
        (torch.zeros(1, 8, 64, 4).transpose(2, 3), kv),         # strides
    ]
    for bq, bkv in bad:
        with pytest.raises(ValueError):
            kernel.check_inputs(bq, bkv, bkv, causal=True, window=0)
    # rows 7.. of a 10-row query see none of 4 keys through a window of 3
    with pytest.raises(ValueError, match="see no key"):
        kernel.check_inputs(torch.zeros(1, 10, 4, 64), torch.zeros(1, 4, 2, 64),
                            torch.zeros(1, 4, 2, 64), causal=True, window=3)


def test_wrapper_has_no_fallback_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises; it is
    never answered by the plain version. A meta tensor (the dry run) takes
    the kernel's own path, which gives the output's shape and launches
    nothing; the kernel's launcher refuses a CPU tensor."""
    def plain(*a, **k):
        raise AssertionError("the plain version answered")
    monkeypatch.setattr(ref, "attention_ref", plain)
    q = torch.zeros(1, 8, 4, 64, device="meta")
    kv = torch.zeros(1, 8, 2, 64, device="meta")
    before = LAUNCHES["flash_attention"]
    o = ops.gqa_attention(q, kv, kv)
    assert o.device.type == "meta" and o.shape == q.shape
    assert LAUNCHES["flash_attention"] == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention(torch.zeros(q.shape), torch.zeros(kv.shape),
                               torch.zeros(kv.shape), scale=0.125)
    assert LAUNCHES["flash_attention"] == before


def _emulate_tensor_core_kernel(q, k, v, *, groups, scale, softcap, causal,
                                window, prefix=0, block_k=64):
    """The bf16 tensor-core kernel's arithmetic, in torch on the CPU:
    head-major q (BHq, Sq, D), k/v (BHkv, Sk, D) in bf16; f32 scores,
    64-key tiles, an online softmax in f32, each p rounded to bf16 before
    P V (f32 sums), l summing the f32 p, the output rounded to bf16."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    kv = torch.arange(BH) // groups
    kf, vf = k[kv].float(), v[kv].float()
    qp = torch.arange(Sq)[:, None]
    m = torch.full((BH, Sq, 1), ref.NEG_INF)
    l = torch.zeros((BH, Sq, 1))
    acc = torch.zeros((BH, Sq, D))
    for k0 in range(0, Sk, block_k):
        kp = torch.arange(k0, min(k0 + block_k, Sk))[None, :]
        s = (q.float() @ kf[:, k0:k0 + block_k].transpose(1, 2)) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        vis = torch.ones_like(qp == kp)
        if causal:
            vis &= kp <= qp
        if window:
            vis &= qp - kp < window
        vis |= kp < prefix
        s = torch.where(vis, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, k0:k0 + block_k]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("cfg", REF_CASES + [
    dict(B=1, S=200, Hq=4, Hkv=1, D=256, window=0, cap=0.0, causal=True,
         prefix=70),
    dict(B=1, S=200, Hq=4, Hkv=1, D=256, window=90, cap=50.0, causal=True)])
def test_tensor_core_rounding_stays_within_the_kernel_limit(cfg):
    """At the reference's four cases the emulated kernel lies within
    kernel_error_limit of the plain version in f32; without its P V term
    (the limit set for an f32-FMA kernel) it would not."""
    B, S, Hq, Hkv, D = cfg["B"], cfg["S"], cfg["Hq"], cfg["Hkv"], cfg["D"]
    _, (q, k, v) = _inputs([(B * Hq, S, D), (B * Hkv, S, D), (B * Hkv, S, D)],
                           jnp.bfloat16, 7)
    kw = dict(groups=Hq // Hkv, scale=D ** -0.5, softcap=cfg["cap"],
              causal=cfg["causal"], window=cfg["window"],
              prefix=cfg.get("prefix", 0))
    got = _emulate_tensor_core_kernel(q, k, v, **kw).float()
    want = ref.attention_ref(q.float(), k.float(), v.float(), **kw)
    pv_abs = ref.attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    err = (got - want).abs()
    assert bool((err <= ref.kernel_error_limit(want, pv_abs,
                                               dtype=torch.bfloat16)).all())
    assert not bool((err <= ref.kernel_error_limit(
        want, dtype=torch.bfloat16)).all())


PREFIX_PROBE_CASES = [(1, 300, 300, 8, 1, 256, 129), (2, 100, 100, 4, 2, 16, 37),
                      (1, 64, 64, 2, 1, 256, 64), (1, 50, 80, 2, 1, 16, 70)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,prefix", PREFIX_PROBE_CASES)
def test_mask_probe_answer_under_a_prefix(B, Sq, Sk, Hq, Hkv, D, prefix):
    """The probe's answer learns the prefix: the plain version gives it
    exactly, and the emulated tensor-core kernel within the tight limit."""
    q, k, v = ref.mask_probe(B, Sq, Sk, Hq, Hkv, D)
    want = ref.mask_probe_answer(B, Sq, Sk, Hq, D, causal=True, window=0,
                                 prefix=prefix)
    o = ops.gqa_attention_ref(q, k, v, causal=True, prefix=prefix)
    assert torch.equal(o, want)
    bh = lambda x: x.transpose(1, 2).reshape(-1, x.shape[1], D)  # noqa: E731
    emu = _emulate_tensor_core_kernel(
        bh(q).bfloat16(), bh(k).bfloat16(), bh(v).bfloat16(), groups=Hq // Hkv,
        scale=D ** -0.5, softcap=0.0, causal=True, window=0, prefix=prefix)
    emu = emu.reshape(B, Hq, Sq, D).transpose(1, 2).float()
    assert bool(((emu - want).abs() <= ref.kernel_error_limit(
        want, dtype=torch.bfloat16)).all())


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,prefix",
                         [c for c in PREFIX_PROBE_CASES if c[-1] < c[2]])
@pytest.mark.parametrize("off", [1, -1])
def test_mask_probe_catches_a_prefix_one_key_off(B, Sq, Sk, Hq, Hkv, D,
                                                 prefix, off):
    """A prefix one key longer or shorter than asked breaks the probe's
    tight limit on the rows before the prefix's end."""
    q, k, v = ref.mask_probe(B, Sq, Sk, Hq, Hkv, D)
    want = ref.mask_probe_answer(B, Sq, Sk, Hq, D, causal=True, window=0,
                                 prefix=prefix)
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    o = _dense_with_mask(q, k, v, (kp <= qp) | (kp < prefix + off))
    lim = ref.kernel_error_limit(want, dtype=torch.bfloat16)
    assert float(((o - want).abs() / lim).max()) > 4


PROBE_CASES = [(2, 256, 256, 4, 2, 64, True, 0), (1, 512, 512, 8, 1, 128, True, 0),
               (2, 256, 256, 4, 4, 64, True, 128), (1, 256, 256, 2, 2, 64, False, 0),
               (1, 300, 300, 4, 2, 32, True, 100), (1, 100, 300, 2, 1, 16, False, 7),
               (1, 300, 200, 2, 2, 16, True, 0)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", PROBE_CASES)
def test_mask_probe_answer_is_the_plain_versions(B, Sq, Sk, Hq, Hkv, D, causal,
                                                 window):
    q, k, v = ref.mask_probe(B, Sq, Sk, Hq, Hkv, D)
    want = ref.mask_probe_answer(B, Sq, Sk, Hq, D, causal=causal, window=window)
    for cap in (0.0, 50.0):
        o = ops.gqa_attention_ref(q, k, v, softcap=cap, causal=causal,
                                  window=window)
        assert torch.equal(o, want)
    # the emulated tensor-core kernel is exact there but for its bf16 output
    bh = lambda x: x.transpose(1, 2).reshape(-1, x.shape[1], D)  # noqa: E731
    emu = _emulate_tensor_core_kernel(
        bh(q).bfloat16(), bh(k).bfloat16(), bh(v).bfloat16(), groups=Hq // Hkv,
        scale=D ** -0.5, softcap=50.0, causal=causal, window=window)
    emu = emu.reshape(B, Hq, Sq, D).transpose(1, 2).float()
    assert bool(((emu - want).abs() <= ref.kernel_error_limit(
        want, dtype=torch.bfloat16)).all())


def _dense_with_mask(q, k, v, mask):
    """Plain attention under an explicit (Sq, Sk) mask: a mask the kernel's
    arguments cannot express, as a broken kernel would apply it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(
        q.shape[2] // k.shape[2], 2))
    p = torch.softmax(torch.where(mask, s, -torch.inf), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.repeat_interleave(
        q.shape[2] // k.shape[2], 2))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window,off", [
    (*c, off) for c in PROBE_CASES if c[6]
    for off in ("diagonal+1", "diagonal-1") + (
        ("window+1", "window-1") if c[7] else ())])
def test_mask_probe_catches_a_mask_one_key_off(B, Sq, Sk, Hq, Hkv, D, causal,
                                               window, off):
    """A mask one key off at the window's edge or the diagonal breaks the
    probe's tight limit, 2**-8 * |o| + ATOL: one key more or less moves a
    row by at least 1 / (its keys + 1), far beyond it."""
    q, k, v = ref.mask_probe(B, Sq, Sk, Hq, Hkv, D)
    want = ref.mask_probe_answer(B, Sq, Sk, Hq, D, causal=causal, window=window)
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    shift = {"window+1": (0, 1), "window-1": (0, -1), "diagonal+1": (1, 0),
             "diagonal-1": (-1, 0)}[off]
    mask = kp <= qp + shift[0]
    if window:
        mask &= qp - kp < window + shift[1]
    mask[:, 0] |= ~mask.any(1)   # keep every row's softmax defined
    o = _dense_with_mask(q, k, v, mask)
    lim = ref.kernel_error_limit(want, dtype=torch.bfloat16)
    assert not bool(((o - want).abs() <= lim).all())
    assert float(((o - want).abs() / lim).max()) > 4


def test_kernel_limit_by_dtype():
    o = torch.tensor([0.0, 1.0, -3.0])
    pv = torch.tensor([2.0, 1.0, 0.5])
    assert torch.equal(ref.kernel_error_limit(o, pv, dtype=torch.float32),
                       torch.full((3,), ref.ATOL))
    assert torch.allclose(ref.kernel_error_limit(o, pv, dtype=torch.bfloat16),
                          2 ** -8 * (o.abs() + pv) + ref.ATOL)
    assert torch.allclose(ref.kernel_error_limit(o, dtype=torch.bfloat16),
                          2 ** -8 * o.abs() + ref.ATOL)
    with pytest.raises(ValueError):
        ref.kernel_error_limit(o, dtype=torch.float16)


def test_tensor_core_instance_checks_tma_alignment():
    """bf16 at head dim 64/128 loads through TMA: the address and every
    stride of a dimension longer than 1 must be a multiple of 16 bytes. The
    FMA instance (f32, or bf16 at head dim 16/32) has no such rule."""
    def make(dtype, width, d=64, offset=0, S=8, H=4):
        flat = torch.zeros(S * H * width + offset, dtype=dtype)
        return flat[offset:].view(1, S, H, width)[..., :d]
    kv = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    ok = dict(causal=True, window=0)
    kernel.check_inputs(make(torch.bfloat16, 64), kv, kv, **ok)
    kernel.check_inputs(make(torch.bfloat16, 72), kv, kv, **ok)   # 144 B rows
    with pytest.raises(ValueError, match="TMA"):
        kernel.check_inputs(make(torch.bfloat16, 68), kv, kv, **ok)  # 136 B
    with pytest.raises(ValueError, match="TMA"):
        kernel.check_inputs(make(torch.bfloat16, 64, offset=4), kv, kv, **ok)
    kernel.check_inputs(make(torch.float32, 68), kv.float(), kv.float(), **ok)
    kv16 = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    kernel.check_inputs(make(torch.bfloat16, 20, d=16), kv16, kv16, **ok)
    # a dimension of length 1 is never stepped: its stride is not checked
    one = torch.zeros(1, 8, 64, 1, dtype=torch.bfloat16).transpose(2, 3)
    kernel.check_inputs(one, one[:, :, :1], one[:, :, :1], **ok)
