"""The CUDA kernels (flash attention, selective scan, egress pack) against
their plain versions on the card.

Marked `cuda`: skips without a GPU and nvcc (the kernel has no CPU or
interpret mode). On the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``. The plain version runs on the same input values
in f32, and each output element must lie within
``ref.kernel_error_limit``: 2e-5 for f32 (fp32 FMAs against fp32 matmuls
summed in another order); for bf16 (the tensor-core instance at head dim
64 and 128, which rounds P to bf16 before P V) 2**-8 * |ref| +
2**-8 * (P |V|) + 2e-5, with P |V| the plain version run on |v|. The mask
probe (q = 0, v = (-1)**k), whose answer is exact, holds bf16 to the tight
2**-8 * |ref| + 2e-5. The scan's plain version runs the same way, and the kernel's y and h_last
must equal its result rounded to their dtype, element for element: the
kernel performs the plain version's roundings in its order (no FMA
contraction, the state sum by halving), so it gives the same bits. The pack
kernel's blocks and scales must equal the plain version's byte for byte.
"""
import pytest

torch = pytest.importorskip("torch")


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
    dict(B=1, Sq=301, Sk=301, Hq=4, Hkv=2, D=128, window=0, cap=0.0, causal=False),
    dict(B=1, Sq=100, Sk=300, Hq=4, Hkv=2, D=64, window=0, cap=30.0, causal=False),
])
def test_kernel_matches_plain(cuda_device, dtype, case):
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ops, ref
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
    pv_abs = ops.gqa_attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    assert o.dtype == dtype and o.shape == want.shape
    err = (o.float() - want).abs()
    lim = ref.kernel_error_limit(want, pv_abs, dtype=dtype)
    assert bool((err <= lim).all()), float((err / lim).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=2, S=256, Hq=4, Hkv=2, D=64, window=0, cap=0.0, causal=True),
    dict(B=1, S=512, Hq=8, Hkv=1, D=128, window=0, cap=50.0, causal=True),
    dict(B=2, S=256, Hq=4, Hkv=4, D=64, window=128, cap=0.0, causal=True),
    dict(B=1, S=256, Hq=2, Hkv=2, D=64, window=0, cap=0.0, causal=False),
    dict(B=4, S=4600, Hq=32, Hkv=16, D=128, window=4096, cap=50.0, causal=True),
    dict(B=4, S=4600, Hq=32, Hkv=16, D=128, window=0, cap=50.0, causal=True),
    dict(B=1, S=301, Hq=4, Hkv=2, D=128, window=0, cap=0.0, causal=False),
], ids=["ref1", "ref2", "ref3", "ref4", "serve-local", "serve-global",
        "ragged-noncausal"])
def test_kernel_mask_probe_is_exact_in_bf16(cuda_device, case):
    """q = 0, v = (-1)**k: every p is 1, so the kernel rounds only its
    output, and one key too many or too few moves a row by at least
    1 / (keys + 1), ten times the tight limit at the serve shape."""
    from repro_torch.kernels.flash_attention import ops, ref
    B, S, Hq, Hkv, D = (case[x] for x in ("B", "S", "Hq", "Hkv", "D"))
    q, k, v = ref.mask_probe(B, S, S, Hq, Hkv, D, dtype=torch.bfloat16,
                             device=cuda_device)
    o = ops.gqa_attention(q, k, v, softcap=case["cap"], causal=case["causal"],
                          window=case["window"])
    want = ref.mask_probe_answer(B, S, S, Hq, D, causal=case["causal"],
                                 window=case["window"], device=cuda_device)
    err = (o.float() - want).abs()
    lim = ref.kernel_error_limit(want, dtype=torch.bfloat16)
    assert bool((err <= lim).all()), float((err / lim).max())


SCAN_CHUNK = 32   # time steps the scan kernel stages at once


@pytest.mark.cuda
@pytest.mark.parametrize("types", [
    ("float32",) * 3, ("bfloat16",) * 3, ("bfloat16", "float32", "bfloat16")],
    ids=["f32", "bf16", "mixed"])
@pytest.mark.parametrize("h0_scale", [1.0, 0.0], ids=["h0", "h0_zero"])
@pytest.mark.parametrize("shape", [
    (2, 64, 256, 16), (1, 100, 300, 8), (2, 128, 512, 16), (3, 1, 77, 16),
    (1, 130, 100, 5),
    (2, 50, 256, 1), (2, 50, 256, 4),         # N = 1 and 4: lanes without states
    (1, 70, 36, 16), (2, 40, 130, 16),        # di leaves part of a warp without channels
    (2, SCAN_CHUNK - 7, 200, 16),             # S < chunk
    (2, SCAN_CHUNK + 1, 200, 16),             # S = chunk + 1
    (2, 40, 77, 16),                          # rows 4-byte aligned only (f32)
    (1, 100, 128, 5)])   # B/C sequence stride 30 B in bf16, neither slice 4-byte aligned
def test_scan_kernel_matches_plain(cuda_device, types, shape, h0_scale):
    """Bm and Cm are the column slices [N:2N] and [2N:3N] of one (B, S, 3N)
    buffer; h0 is random (nonzero) or zero."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ssm_scan import kernel, ops, ref
    assert kernel.chunk_steps() == SCAN_CHUNK   # the S cases bracket a chunk
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
    h0 = rn(B, di, N) * h0_scale
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


@pytest.mark.cuda
@pytest.mark.parametrize("out", [None, torch.int8, torch.bfloat16],
                         ids=["same", "int8", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,tile", [((256, 128), (256, 128)),
                                        ((512, 256), (256, 128)),
                                        ((64, 384), (8, 128))],
                         ids=["256x128", "512x256", "64x384"])
def test_pack_kernel_matches_plain(cuda_device, shape, tile, dtype, out):
    """Byte for byte: both divide in IEEE f32 and round half to even."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.staging_pack import kernel, ref
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    before = LAUNCHES["staging_pack"]
    b, s = kernel.pack_blocks(x, tile=tile, out_dtype=out)
    torch.cuda.synchronize()
    assert LAUNCHES["staging_pack"] == before + 1
    b_p, s_p = ref.pack_blocks_ref(x, tile=tile, out_dtype=out)
    assert b.dtype == b_p.dtype and torch.equal(b, b_p) and torch.equal(s, s_p)


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.int8, torch.bfloat16, torch.float32],
                         ids=["int8", "bf16", "f32"])
def test_pack_kernel_takes_float16(cuda_device, out):
    """A float16 input, widened to f32 in the kernel: byte for byte the
    plain version's (there is no float16 output)."""
    from repro_torch.kernels.staging_pack import kernel, ref
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = (torch.randn((64, 384), generator=g, device=cuda_device) * 5).half()
    b, s = kernel.pack_blocks(x, tile=(8, 128), out_dtype=out)
    b_p, s_p = ref.pack_blocks_ref(x, tile=(8, 128), out_dtype=out)
    assert b.dtype == out and torch.equal(b, b_p) and torch.equal(s, s_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4096, 5000, 3 * 4096 + 17, 201 * 501 * 501])
def test_quantize_blocks_kernel_matches_plain(cuda_device, n):
    """The codec's variant with the ragged last block masked in the kernel,
    up to the paper's 201x501x501 mesh; the plain version pads."""
    from repro_torch.kernels.staging_pack import ops, ref
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(n, generator=g, device=cuda_device) * 3
    # exact ties: with amax 127 in the first block its scale is 1
    ties = torch.tensor([70.5, -70.5, 0.5, 1.5, 2.5, -2.5, 126.5, 127.0])
    x[:8] = ties[:n]
    q, s = ops.quantize_blocks(x)
    nb = s.numel()
    xp = torch.nn.functional.pad(x, (0, nb * 4096 - n)).reshape(nb * 32, 128)
    q_p, s_p = ref.pack_blocks_ref(xp, tile=(32, 128), out_dtype=torch.int8)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    if n >= 8:
        assert q[0, :7].tolist() == [70, -70, 0, 2, 2, -2, 126]


@pytest.mark.cuda
def test_quantize_blocks_kernel_gives_underflowing_blocks_scale_one(cuda_device):
    """amax / 127 underflows to 0 in the first block: scale 1 and q = 0, the
    host codec's bytes; the second block's scale is subnormal, not 0."""
    from repro_torch.kernels.staging_pack import ops
    x = torch.zeros(2 * 4096, device=cuda_device)
    x[:3] = torch.tensor([4e-44, -7e-45, 1.4e-45])
    x[4096:4099] = torch.tensor([2e-38, 1e-39, -5e-40])
    q, s = ops.quantize_blocks(x)
    q_p, s_p = ops.quantize_blocks(x.cpu())
    assert s[0].item() == 1.0 and not q[0].any().item()
    assert torch.equal(q.cpu(), q_p) and torch.equal(s.cpu(), s_p)


@pytest.mark.cuda
def test_sink_packs_a_cuda_tensor_on_the_card(cuda_device):
    """A CUDA float tensor staged with codec int8-block launches the kernel
    once and lands in SAVIME as the host path's bytes decode."""
    import numpy as np

    from repro_torch.codec.int8block import Int8BlockCodec
    from repro_torch.core import (InTransitConfig, InTransitSink,
                                  SavimeServer, StagingServer)
    from repro_torch.kernels import LAUNCHES
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(3 * 4096 + 17, generator=g, device=cuda_device)
    sv = SavimeServer().start()
    st = StagingServer(sv.addr, mem_capacity=16 << 20).start()
    try:
        sink = InTransitSink(st.addr, InTransitConfig(codec="int8-block"))
        before = LAUNCHES["staging_pack"]
        sink.stage_array("x", x, step=0)
        assert LAUNCHES["staging_pack"] == before + 1
        sink.close()
        got = sv.engine.tars["run_x"].select("v")[0]
        codec = Int8BlockCodec()
        want = codec.decode(*codec.encode(x.cpu().numpy())).view(np.float32)
        assert got.tobytes() == want.tobytes()
    finally:
        st.stop()
        sv.stop()


@pytest.mark.cuda
def test_float16_pack_equals_the_host_codec(cuda_device):
    """A float16 CUDA tensor with codec int8-block: the kernel's payload
    equals the numpy host codec's byte for byte (both widen to f32)."""
    import numpy as np

    from repro_torch.codec.int8block import Int8BlockCodec
    from repro_torch.kernels import LAUNCHES
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = (torch.randn(3 * 4096 + 17, generator=g, device=cuda_device) * 9
         ).to(torch.float16)
    codec = Int8BlockCodec()
    before = LAUNCHES["staging_pack"]
    payload, meta = codec.encode(x)
    assert LAUNCHES["staging_pack"] == before + 1 and meta["dtype"] == "float16"
    host, host_meta = codec.encode(x.cpu().numpy())
    assert bytes(memoryview(payload)) == host and meta == host_meta
    back = codec.decode(payload, meta).view(np.float16)
    assert back.tobytes() == codec.decode(host, host_meta).tobytes()


@pytest.mark.cuda
def test_bf16_cuda_tensor_stages_without_jax(cuda_device):
    """In a process without jax, jaxlib, ml_dtypes or repro: a bf16 CUDA
    tensor stages for codec none / int8-block x quantize none / int8. With
    int8-block alone the kernel packs it on the card (one launch) and
    SAVIME holds the decode of that, equal to the same codec's on the CPU;
    otherwise SAVIME holds its bits."""
    from _torch_bf16_staging import run
    rows = run("cuda")
    assert len(rows) == 4
    for r in rows:
        assert r["imported"] == [] and r["attr"][0] == "bfloat16"
        assert r["held"] == ["uint16", [1, 8197]] and r["bits_equal"]
        assert r["query"] == ["float32", [1, 8197]] and r["query_equal"]
        packed = r["codec"] == "int8-block" and r["quantize"] == "none"
        assert r["packed"] == packed and r["launches"] == int(packed)
        assert r["max_err"] <= (2 / 127 if packed else 0.0)


def test_cuda_marker_is_registered(pytestconfig):
    assert any(m.startswith("cuda:") for m in pytestconfig.getini("markers"))
