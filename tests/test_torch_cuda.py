"""The CUDA flash-attention kernel against its plain version on the card.

Marked `cuda`: skips without a GPU and nvcc (the kernel has no CPU or
interpret mode). On the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``. The plain version runs on the same input values
in f32, and each output element must lie within REL * |ref| + 2e-5: 2e-5
for fp32 FMAs against fp32 matmuls summed in another order, and for bf16
half a bf16 step (2**-8 of the value), as rounding to nearest even gives.
"""
import pytest

torch = pytest.importorskip("torch")

ATOL = 2e-5
REL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(B=2, Sq=256, Sk=256, Hq=4, Hkv=2, D=64, window=0, cap=0.0, causal=True),
    dict(B=1, Sq=512, Sk=512, Hq=8, Hkv=1, D=128, window=0, cap=50.0, causal=True),
    dict(B=2, Sq=300, Sk=300, Hq=4, Hkv=1, D=32, window=100, cap=50.0, causal=True),
    dict(B=1, Sq=100, Sk=300, Hq=4, Hkv=4, D=16, window=0, cap=0.0, causal=False),
])
def test_kernel_matches_plain(cuda_device, dtype, case):
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def mk(S, H):
        return torch.randn((case["B"], S, H, case["D"]), generator=g,
                           device=cuda_device).to(dtype)

    q, k, v = mk(case["Sq"], case["Hq"]), mk(case["Sk"], case["Hkv"]), \
        mk(case["Sk"], case["Hkv"])
    kw = dict(softcap=case["cap"], causal=case["causal"], window=case["window"])
    before = LAUNCHES["flash_attention"]
    o = ops.gqa_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    want = ops.gqa_attention_ref(q.float(), k.float(), v.float(), **kw)
    assert o.dtype == dtype and o.shape == want.shape
    err = (o.float() - want).abs()
    assert bool((err <= REL[dtype] * want.abs() + ATOL).all()), float(err.max())


def test_cuda_marker_is_registered(pytestconfig):
    assert any(m.startswith("cuda:") for m in pytestconfig.getini("markers"))
