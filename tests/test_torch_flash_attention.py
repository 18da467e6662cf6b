"""Port parity: the plain version of the flash-attention kernel
(repro_torch.kernels.flash_attention) against the reference's Pallas kernel
run in interpret mode and against its dense oracle.

Tolerances are the reference's own (tests/test_kernels.py): 2e-6 for f32,
2e-2 for bf16. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
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


def test_kernel_rejects_what_it_does_not_take():
    q = torch.zeros(1, 8, 4, 64)
    kv = torch.zeros(1, 8, 2, 64)
    kernel.check_inputs(q, kv, kv, causal=True, window=0)      # accepted
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


def test_wrapper_has_no_fallback_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; it is
    never answered by the plain version."""
    q = torch.zeros(1, 8, 4, 64, device="meta")
    kv = torch.zeros(1, 8, 2, 64, device="meta")
    before = LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="CUDA"):
        ops.gqa_attention(q, kv, kv)
    assert LAUNCHES["flash_attention"] == before
