"""The CUDA kernels (flash attention, decode attention, selective scan,
egress pack) against their plain versions on the card.

Marked `cuda`: skips without a GPU and nvcc (the kernel has no CPU or
interpret mode). On the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``. The plain version runs on the same input values
in f32, and each output element must lie within
``ref.kernel_error_limit``: 2e-5 for f32 (fp32 FMAs against fp32 matmuls
summed in another order); for bf16 (the tensor-core instance at head dim
64, 128 and 256, which rounds P to bf16 before P V) 2**-8 * |ref| +
2**-8 * (P |V|) + 2e-5, with P |V| the plain version run on |v|. The mask
probe (q = 0, v = (-1)**k), whose answer is exact, holds bf16 to the tight
2**-8 * |ref| + 2e-5. The scan's plain version runs the same way, and the kernel's y and h_last
must equal its result rounded to their dtype, element for element: the
kernel performs the plain version's roundings in its order (no FMA
contraction, the state sum by halving), so it gives the same bits. The pack
kernel's blocks and scales must equal the plain version's byte for byte.
The decode kernel runs against its plain version on the same inputs in the
same dtype: per element 2**-7 max|v| in bf16, 1e-5 max|v| in f32.
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
    # head dim 256 (gemma3, paligemma, recurrentgemma): the 1-stage
    # tensor-core instance, the FMA instance in f32; the prefix-LM mask
    dict(B=2, Sq=300, Sk=300, Hq=4, Hkv=1, D=256, window=100, cap=0.0, causal=True),
    dict(B=1, Sq=200, Sk=200, Hq=8, Hkv=1, D=256, window=0, cap=50.0, causal=True,
         prefix=70),
    dict(B=1, Sq=256, Sk=256, Hq=4, Hkv=2, D=128, window=0, cap=0.0, causal=True,
         prefix=128),
    dict(B=1, Sq=150, Sk=150, Hq=2, Hkv=1, D=32, window=0, cap=0.0, causal=True,
         prefix=101),
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
    kw = dict(softcap=case["cap"], causal=case["causal"], window=case["window"],
              prefix=case.get("prefix", 0))
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
    dict(B=1, S=300, Hq=4, Hkv=1, D=256, window=100, cap=0.0, causal=True),
    dict(B=1, S=300, Hq=8, Hkv=1, D=256, window=0, cap=0.0, causal=True,
         prefix=129),
    dict(B=1, S=4600, Hq=8, Hkv=1, D=256, window=0, cap=0.0, causal=True,
         prefix=256),
], ids=["ref1", "ref2", "ref3", "ref4", "serve-local", "serve-global",
        "ragged-noncausal", "d256-window", "d256-prefix", "paligemma-prefix"])
def test_kernel_mask_probe_is_exact_in_bf16(cuda_device, case):
    """q = 0, v = (-1)**k: every p is 1, so the kernel rounds only its
    output, and one key too many or too few moves a row by at least
    1 / (keys + 1), ten times the tight limit at the serve shape."""
    from repro_torch.kernels.flash_attention import ops, ref
    B, S, Hq, Hkv, D = (case[x] for x in ("B", "S", "Hq", "Hkv", "D"))
    q, k, v = ref.mask_probe(B, S, S, Hq, Hkv, D, dtype=torch.bfloat16,
                             device=cuda_device)
    prefix = case.get("prefix", 0)
    o = ops.gqa_attention(q, k, v, softcap=case["cap"], causal=case["causal"],
                          window=case["window"], prefix=prefix)
    want = ref.mask_probe_answer(B, S, S, Hq, D, causal=case["causal"],
                                 window=case["window"], prefix=prefix,
                                 device=cuda_device)
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
@pytest.mark.parametrize("types", [("float32",) * 3, ("bfloat16", "float32", "bfloat16")],
                         ids=["f32", "mixed"])
@pytest.mark.parametrize("chunk", [0, 7], ids=["whole", "chunked"])
def test_scan_function_grads_equal_plain_on_the_card(cuda_device, types, chunk,
                                                    monkeypatch):
    """``SelectiveScan`` on the card (the kernel forward, one launch) and its
    gradients against autograd through the plain scan on the same inputs:
    the same bits with the whole sequence recomputed; within 1e-6 of each
    gradient's max |g| recomputed 7 steps at a time (dA then sums its time
    steps in another order)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ssm_scan import ops, ref
    if chunk:
        monkeypatch.setattr(ops, "recompute_chunk", lambda *a: chunk)
    B, S, di, N = 2, 50, 130, 16
    x_dt, dt_dt, bc_dt = (getattr(torch, t) for t in types)
    g = torch.Generator(device=cuda_device).manual_seed(2)

    def rn(*s):
        return torch.randn(s, generator=g, device=cuda_device)

    def inputs():
        return [rn(B, S, di).to(x_dt).requires_grad_(),
                (torch.nn.functional.softplus(rn(B, S, di)) * 0.1).to(dt_dt).requires_grad_(),
                rn(B, S, N).to(bc_dt).requires_grad_(), rn(B, S, N).to(bc_dt).requires_grad_(),
                (-torch.exp(rn(di, N) * 0.2)).requires_grad_(), rn(B, di, N).requires_grad_()]

    ins = inputs()
    plain = [t.detach().clone().requires_grad_() for t in ins]
    dy = rn(B, S, di).to(x_dt)
    dh = rn(B, di, N)
    before = LAUNCHES["ssm_scan"]
    y, h = ops.selective_scan(*ins)
    assert LAUNCHES["ssm_scan"] == before + 1
    got = torch.autograd.grad([y, h], ins, [dy, dh])
    assert LAUNCHES["ssm_scan"] == before + 1        # the backward is plain
    y_p, h_p = ref.ssm_scan_ref(*plain)
    want = torch.autograd.grad([y_p, h_p], plain, [dy, dh])
    assert torch.equal(y, y_p) and torch.equal(h, h_p)
    for a, b in zip(got, want):
        if chunk:
            assert float((a.float() - b.float()).abs().max()) <= 1e-6 * float(b.float().abs().max())
        else:
            assert torch.equal(a, b)


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


def _stage_on_card(x, transport: str, spec: str = "", **cfg) -> dict:
    """Stage the CUDA tensor ``x`` through the port's sink on ``transport``
    with codec int8-block and read back what SAVIME holds; a fault plan
    ``spec`` rides the port's wire meanwhile."""
    from repro_torch.core import (InTransitConfig, InTransitSink,
                                  SavimeServer, StagingServer)
    from repro_torch.faults import FaultPlan, injected
    from repro_torch.kernels import LAUNCHES, reset_launches
    sv = SavimeServer().start()
    st = StagingServer(sv.addr, mem_capacity=64 << 20).start()
    try:
        with injected(FaultPlan.parse(spec), scope=[st.addr]) as inj:
            sink = InTransitSink(st.addr if transport == "rdma_staged"
                                 else sv.addr, InTransitConfig(
                                     codec="int8-block", transport=transport,
                                     **cfg))
            try:
                reset_launches()
                sink.stage_array("x", x, step=0)
                sink.flush(timeout=60)
                launches = LAUNCHES["staging_pack"]
            finally:
                sink.close()
        held = sv.engine.tars["run_x"].select("v")[0]
    finally:
        st.stop()
        sv.stop()
    stats = sink.session.stats
    return {"held": held, "launches": launches, "codec": stats.codec,
            "channels": stats.channels, "replays": stats.replays,
            "fired": dict(inj.fired)}


def _host_decode(x):
    import numpy as np

    from repro_torch.codec.int8block import Int8BlockCodec
    codec = Int8BlockCodec()
    return codec.decode(*codec.encode(x.cpu().numpy())).view(np.float32)


@pytest.mark.cuda
def test_striped_sink_packs_a_cuda_tensor_once(cuda_device):
    """n_channels=2 with int8-block: one pack launch on the card, the
    reduced bytes striped over both channels, and SAVIME holds the host
    codec's decode byte for byte."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(64 * 4096 + 17, generator=g, device=cuda_device)
    r = _stage_on_card(x, "rdma_staged", n_channels=2, stripe_bytes=64 << 10)
    assert r["launches"] == 1 and r["codec"]["datasets"] == 1
    assert r["codec"]["wire_bytes"] == x.numel() + 4 * 65
    assert len(r["channels"]) == 2 and all(c["n_stripes"] > 0
                                           for c in r["channels"])
    assert r["held"].tobytes() == _host_decode(x).tobytes()


@pytest.mark.cuda
def test_copy_baseline_ships_a_cuda_tensor_raw(cuda_device):
    """scp_mem with int8-block set: the tensor is copied to the host and
    lands raw (the codec is inert on a baseline); no pack launch."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(64 * 4096 + 17, generator=g, device=cuda_device)
    r = _stage_on_card(x, "scp_mem")
    assert r["launches"] == 0 and r["codec"] == {}
    assert r["held"].tobytes() == x.cpu().numpy().tobytes()


@pytest.mark.cuda
def test_forced_replay_packs_the_cuda_tensor_again(cuda_device):
    """A session with no per-write retries under drop:op=stripe_open,nth=1:
    the write fails, the journal replays it, and the replay encodes the
    CUDA tensor again: launches = 1 + replays = 2; SAVIME holds the host
    codec's decode."""
    import numpy as np

    from repro_torch.core import SavimeServer, StagingServer
    from repro_torch.faults import FaultPlan, injected
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.transport import TransferSession, TransportConfig
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(64 * 4096 + 17, generator=g, device=cuda_device)
    sv = SavimeServer().start()
    st = StagingServer(sv.addr, mem_capacity=64 << 20).start()
    try:
        with injected(FaultPlan.parse("seed=5;drop:op=stripe_open,nth=1"),
                      scope=[st.addr]) as inj:
            cfg = TransportConfig(staging_addr=st.addr, codec="int8-block",
                                  n_channels=2, stripe_bytes=64 << 10,
                                  retry=0)
            with TransferSession("rdma_staged", cfg) as sess:
                reset_launches()
                sess.write("D", x)
                sess.sync(60)
                launches = LAUNCHES["staging_pack"]
        held = sv.engine.datasets["D"]
    finally:
        st.stop()
        sv.stop()
    assert inj.fired == {"drop": 1} and sess.stats.replays == 1
    assert launches == 1 + sess.stats.replays
    assert held.view(np.float32).tobytes() == _host_decode(x).tobytes()


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


def _rel_frobenius(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_gradients_match_plain(cuda_device, dtype):
    """The kernel's autograd.Function on the card: one launch forward (the
    output within kernel_error_limit), and dq, dk, dv (the plain version
    recomputed and differentiated by row chunks) nonzero and within the
    training gate of plain autograd through the whole plain version: 1e-2
    relative (Frobenius)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ops, ref
    g = torch.Generator(device=cuda_device).manual_seed(8)
    Bq, Sq, Hq, Hkv, D = 2, 300, 4, 2, 128
    mk = lambda H: torch.randn((Bq, Sq, H, D), generator=g,  # noqa: E731
                               device=cuda_device).to(dtype)
    q, k, v, do = mk(Hq), mk(Hkv), mk(Hkv), mk(Hq)
    kw = dict(scale=(4608 / 32) ** -0.5, softcap=50.0, causal=True, window=100)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = LAUNCHES["flash_attention"]
    o = ops.gqa_attention(*leaves, **kw)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    want_o = ops.gqa_attention_ref(q.float(), k.float(), v.float(), **kw)
    pv_abs = ops.gqa_attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    lim = ref.kernel_error_limit(want_o, pv_abs if dtype == torch.bfloat16
                                 else None, dtype=dtype)
    assert bool(((o.float() - want_o).abs() <= lim).all())
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops.gqa_attention_ref(*plain, **kw), plain, do)
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float(a.float().abs().max()) > 0, name
        assert _rel_frobenius(a, b) <= 1e-2, (name, _rel_frobenius(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_launches_and_gradients_on_the_card(cuda_device, remat,
                                                       monkeypatch):
    """A train step of the gemma2 smoke model widened to head dim 128 (the
    wgmma instance), 2 layers (one local/global period, as the training cell
    of chip_smoke.py), 2 microbatches, grads_int8 egress: the flash
    kernel launches once a layer a microbatch forward, and once more in the
    backward's recompute under remat; the pack kernel once a step. Every
    leaf's gradient lies within 1e-2 relative (Frobenius) of the same step's
    through the plain attention, the attention projections included."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, batch_to_device
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import Model
    from repro_torch.models import attention as attention_mod
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import TrainConfig, TrainSetup
    cfg = dataclasses.replace(get_config("gemma2-27b").smoke(), n_layers=2,
                              head_dim=128, remat=remat)
    ts = TrainSetup(Model(cfg), TrainConfig(microbatches=2, egress="grads_int8",
                                            egress_blocks=8))
    state = ts.init_state(0, cuda_device)
    b = batch_to_device(next(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=96, global_batch=4)).batches()),
        cuda_device)
    reset_launches()
    loss, _, grads = ts.loss_and_grads(state["params"], b)
    torch.cuda.synchronize()
    per_micro = 2 if remat == "full" else 1
    assert LAUNCHES["flash_attention"] == 2 * 2 * per_micro
    with monkeypatch.context() as mp:
        mp.setattr(attention_mod, "gqa_attention", ops.gqa_attention_ref)
        loss_p, _, grads_p = ts.loss_and_grads(state["params"], b)
    assert abs(float(loss) - float(loss_p)) <= 1e-3 * abs(float(loss_p))
    for a, c in zip(tree_leaves(grads), tree_leaves(grads_p)):
        assert _rel_frobenius(a, c) <= 1e-2
    for proj in ("wq", "wk", "wv", "wo"):
        assert float(grads["rem"]["1:global"]["attn"][proj].abs().max()) > 0
    reset_launches()
    state, m, e = ts.step_fn()(state, b)
    torch.cuda.synchronize()
    assert LAUNCHES == {"decode_attention": 0, "flash_attention": 2 * 2 * per_micro,
                        "ssm_scan": 0, "staging_pack": 1}
    assert e["blocks"].shape == (8, 1024) and bool(torch.isfinite(m["loss"]))


def _written_positions(pos, T, device):
    """(B, T) int32: what a cache of T slots holds after row b wrote
    positions 0..pos_b one at a time at slot p % T (-1: never written)."""
    t = torch.arange(T, device=device)
    rows = [torch.where(t <= p, p - (p - t) % T, torch.full_like(t, -1)) for p in pos]
    return torch.stack(rows).to(torch.int32)


# (T, window, the rows' positions): a cache longer than a split, its rows at
# very different positions (0, one slot short of T, past T: wrapped), with
# a run of empty slots inside a row's range; a window ring that has wrapped;
# a window narrower than the cache; a cache shorter than one split
DECODE_CACHES = [(300, 0, [0, 37, 299, 650, 120]), (100, 100, [3, 99, 250, 1000, 57]),
                 (200, 50, [199, 120, 10, 400, 75]), (40, 0, [39, 0, 17, 41, 2])]


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("G", [1, 2, 8, 48])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda_device, dtype, D, G, cap):
    """The decode kernel against the plain version on the same inputs and
    dtype, on every cache of DECODE_CACHES, at the launcher's split of the
    slot axis and at one split; and a cache split over two ranks of a
    sequence group: each rank's partial (m, l, o) against the plain
    partial, and the two combined against the plain version over the whole
    cache. Per element: bf16 |o - plain| <= 2**-7 max|v| (one rounding of p
    and one of o at another place than the plain version's); f32 1e-5
    max|v| (the order of the sums); m within 1e-5 (1 + |m|); a rank that
    holds no valid slot of a row gives m = -2e38, as the plain one does."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention import kernel, ref
    Hkv = 1 if G == 48 else 3 if G == 2 else 2
    Hq = G * Hkv
    gen = torch.Generator(device=cuda_device).manual_seed(D * 100 + G)

    def mk(*shape, mul=1.0):
        return (torch.randn(shape, generator=gen, device=cuda_device) * mul).to(dtype)

    def limit(v):
        return (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * float(v.float().abs().max())

    kw = dict(scale=D ** -0.5, cap=cap)
    for T, window, pos in DECODE_CACHES:
        B = len(pos)
        q, k, v = mk(B, 1, Hq, D, mul=3.0), mk(B, T, Hkv, D), mk(B, T, Hkv, D)
        cp = _written_positions(pos, T, cuda_device)
        if T == 300:
            cp[4, 50:60] = -1                    # empty slots inside the range
        args = dict(pos=torch.tensor(pos, dtype=torch.int32, device=cuda_device),
                    cache_positions=cp, window=window, **kw)
        want = ref.decode_attention(q, k, v, **args).float()
        before = LAUNCHES["decode_attention"]
        got = kernel.decode_attention(q, k, v, **args)
        torch.cuda.synchronize()
        assert LAUNCHES["decode_attention"] == before + 1
        assert got.dtype == dtype and got.shape == want.shape
        err = float((got.float() - want).abs().max())
        assert err <= limit(v), (T, window, err, limit(v))
        one = torch.empty_like(got)
        kernel._launch(q, k, v, args["pos"], cp, one, scale=kw["scale"], cap=cap,
                       window=window, seq_index=0, partial=False, splits=1,
                       chunk=-(-T // 64) * 64)
        torch.cuda.synchronize()
        err = float((one.float() - want).abs().max())
        assert err <= limit(v), (T, window, "one split", err)

    # a global cache of 256 slots split over two ranks of 128
    pos = [5, 130, 255, 600, 127]
    B, T = len(pos), 256
    q, k, v = mk(B, 1, Hq, D, mul=3.0), mk(B, T, Hkv, D), mk(B, T, Hkv, D)
    cp = _written_positions(pos, T, cuda_device)
    args = dict(pos=torch.tensor(pos, dtype=torch.int32, device=cuda_device), **kw)
    parts = []
    for r in (0, 1):
        mine = slice(r * 128, (r + 1) * 128)
        local = dict(cache_positions=cp[:, mine].contiguous(), **args)
        part = kernel.decode_attention(q, k[:, mine], v[:, mine], **local,
                                       seq_index=r, partial=True)
        plain = ref.decode_partial(q, k[:, mine], v[:, mine], **local)
        torch.cuda.synchronize()
        assert part.dtype == torch.float32 and part.shape == plain.shape
        empty = plain[..., 0] == ref.NEG_INF
        assert torch.equal(part[..., 0] == ref.NEG_INF, empty), r
        m_p, m_k = plain[..., 0][~empty], part[..., 0][~empty]
        assert bool(((m_k - m_p).abs() <= 1e-5 * (1 + m_p.abs())).all()), r
        o_p = (plain[..., 2:] / plain[..., 1:2])[~empty]
        o_k = (part[..., 2:] / part[..., 1:2])[~empty]
        assert float((o_k - o_p).abs().max()) <= limit(v), r
        parts.append(part)
    got = ref.combine(parts, dtype)
    want = ref.decode_attention(q, k, v, cache_positions=cp, **args).float()
    assert float((got.float() - want).abs().max()) <= limit(v)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", [("qwen2-72b", 16), ("gemma2-27b", 128)])
def test_decode_step_launches_the_kernel_once_an_attention_layer(cuda_device, arch,
                                                                 head_dim, monkeypatch):
    """A decode step of a smoke model on the card launches the decode
    kernel once an attention layer (local and global alike), and its bf16
    logits lie within 2**-5 of their largest magnitude (four bf16 steps at
    the largest logit's binade) of the same step's through the plain decode
    attention: the two attentions' outputs differ by a rounding of p and
    of o, which the layers after them carry into the logits. A planted
    fault, the plain version reading its slots from 1 instead of 0 (an
    off-by-one at the start of the slot range), must move the logits past
    that limit (on the CPU it moves them 3.3 and 9.2 times the limit).
    Dropping the newest slot instead moves qwen2-72b's smoke logits by only
    0.19 of the limit; test_decode_kernel_matches_plain catches that fault
    at 2.1 times its per-element limit or more in every case."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.decode_attention import ref
    from repro_torch.models import Model
    from repro_torch.models import attention as attention_mod
    from repro_torch.train.serve_step import ServeSetup
    cfg = dataclasses.replace(get_config(arch).smoke(), head_dim=head_dim)
    serve = ServeSetup(Model(cfg))
    with torch.inference_mode():
        params = serve.init_params(0, cuda_device)
        toks = torch.arange(3 * 40, device=cuda_device).reshape(3, 40) % cfg.vocab_size
        _, cache = serve.prefill_fn(max_len=64)(params, {"tokens": toks})
        batch = {"tokens": toks[:, :1],
                 "pos": torch.full((3,), 40, dtype=torch.int32, device=cuda_device)}
        plain_cache = torch.utils._pytree.tree_map(torch.clone, cache)
        fault_cache = torch.utils._pytree.tree_map(torch.clone, cache)
        reset_launches()
        logits, _ = serve.decode_fn()(params, cache, batch)
        torch.cuda.synchronize()
        n_attn = sum(k in ("dense", "local", "global", "moe") for k in cfg.layer_kinds)
        assert n_attn > 0
        assert LAUNCHES == {"decode_attention": n_attn, "flash_attention": 0,
                            "ssm_scan": 0, "staging_pack": 0}
        monkeypatch.setattr(attention_mod.decode_kernel, "decode_attention",
                            lambda q, k, v, **kw: ref.decode_attention(q, k, v, **kw))
        want, _ = serve.decode_fn()(params, plain_cache, batch)

        def from_slot_1(q, k, v, *, cache_positions, **kw):
            cache_positions = cache_positions.clone()
            cache_positions[:, 0] = -1
            return ref.decode_attention(q, k, v, cache_positions=cache_positions, **kw)
        monkeypatch.setattr(attention_mod.decode_kernel, "decode_attention", from_slot_1)
        fault, _ = serve.decode_fn()(params, fault_cache, batch)
    limit = 2.0 ** -5 * float(want.float().abs().max())
    err = float((logits.float() - want.float()).abs().max())
    assert err <= limit, err
    assert float((fault.float() - want.float()).abs().max()) > limit


def test_cuda_marker_is_registered(pytestconfig):
    assert any(m.startswith("cuda:") for m in pytestconfig.getini("markers"))
