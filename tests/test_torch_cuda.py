"""The CUDA kernels (flash attention, selective scan) against their plain
versions on the card.

Marked `cuda`: skips without a GPU and nvcc (the kernel has no CPU or
interpret mode). On the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``. The plain version runs on the same input values
in f32, and each output element must lie within REL * |ref| + 2e-5: 2e-5
for fp32 FMAs against fp32 matmuls summed in another order, and for bf16
half a bf16 step (2**-8 of the value), as rounding to nearest even gives.
The scan's plain version runs the same way, and the kernel's y and h_last
must equal its result rounded to their dtype, element for element: the
kernel performs the plain version's roundings in its order (no FMA
contraction, the state sum by halving), so it gives the same bits.
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


@pytest.mark.cuda
@pytest.mark.parametrize("types", [
    ("float32",) * 3, ("bfloat16",) * 3, ("bfloat16", "float32", "bfloat16")],
    ids=["f32", "bf16", "mixed"])
@pytest.mark.parametrize("shape", [
    (2, 64, 256, 16), (1, 100, 300, 8), (2, 128, 512, 16), (3, 1, 77, 16),
    (1, 130, 100, 5)])
def test_scan_kernel_matches_plain(cuda_device, types, shape):
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ssm_scan import ops, ref
    B, S, di, N = shape
    x_dt, dt_dt, bc_dt = (getattr(torch, t) for t in types)
    g = torch.Generator(device=cuda_device).manual_seed(1)

    def rn(*s):
        return torch.randn(s, generator=g, device=cuda_device)

    xi = rn(B, S, di).to(x_dt)
    dt = (torch.nn.functional.softplus(rn(B, S, di)) * 0.1).to(dt_dt)
    # Bm, Cm as column slices of one buffer, as the model's x_proj gives them
    bc = rn(B, S, 3 * N).to(bc_dt)
    Bm, Cm = bc[..., N:2 * N], bc[..., 2 * N:]
    A = -torch.exp(rn(di, N) * 0.2)
    h0 = rn(B, di, N)
    before = LAUNCHES["ssm_scan"]
    y, h = ops.selective_scan(xi, dt, Bm, Cm, A, h0)
    torch.cuda.synchronize()
    assert LAUNCHES["ssm_scan"] == before + 1
    y_p, h_p = ref.ssm_scan_ref(xi.float(), dt.float(), Bm.float(), Cm.float(),
                                A, h0)
    assert y.dtype == x_dt and y.shape == (B, S, di)
    assert h.dtype == torch.float32 and h.shape == (B, di, N)
    for got, want in ((y, y_p), (h, h_p)):
        same = got == want.to(got.dtype)
        assert bool(same.all()), float(same.float().mean())


def test_cuda_marker_is_registered(pytestconfig):
    assert any(m.startswith("cuda:") for m in pytestconfig.getini("markers"))
