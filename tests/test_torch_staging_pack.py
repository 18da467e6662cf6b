"""Port parity for the egress pack: repro_torch's plain version (what the
wrappers run on a CPU tensor) against the reference's ``ref`` / ``ops``
(``impl="xla"``) and its Pallas kernel in interpret mode, on the same numpy
inputs; and the port's ``Int8BlockCodec`` against the reference's.

Tolerances: against the reference's plain (XLA) path and the host codec,
byte equality, blocks and scales alike: both divide in IEEE f32 (amax / 127,
then x / scale) and round half to even, and the staging server decodes
these bytes. (Where amax / 127 underflows to 0, the port follows the host
codec, not the reference's ref.py: see the underflow test.) Against the interpreted Pallas kernel, the reference's own
bound (tests/test_kernels.py): at most one quantization step on fewer than
1e-3 of the elements, scales to rtol 1e-6, because the interpreted kernel
computes ``amax / 127.0`` as ``amax * (1 / 127)``, one ulp off the quotient
for some blocks.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.codec.int8block import Int8BlockCodec as RefCodec  # noqa: E402
from repro.kernels.staging_pack import kernel as jkernel  # noqa: E402
from repro.kernels.staging_pack import ops as jops  # noqa: E402
from repro.kernels.staging_pack import ref as jref  # noqa: E402
from repro_torch.codec.base import as_bytes_array  # noqa: E402
from repro_torch.codec.int8block import Int8BlockCodec  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.staging_pack import kernel, ops, ref  # noqa: E402

CPU = torch.device("cpu")
BF16 = ml_dtypes.bfloat16
TORCH_DT = {None: None, "int8": torch.int8, "bfloat16": torch.bfloat16}
JAX_DT = {None: None, "int8": jnp.int8, "bfloat16": jnp.bfloat16}
PACK_CASES = [((256, 128), (256, 128)), ((512, 256), (256, 128)),
              ((64, 384), (8, 128))]


def _normal(shape, dtype=np.float32, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32).astype(dtype)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _same_bytes(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = _np(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("out", [None, "int8", "bfloat16"])
@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,tile", PACK_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_pack_matches_reference_byte_for_byte(shape, tile, dtype, out):
    x = _normal(shape, dtype)
    b, s = ref.pack_blocks_ref(tensor_from_numpy(x, CPU), tile=tile,
                               out_dtype=TORCH_DT[out])
    br, sr = jref.pack_blocks_ref(jnp.asarray(x), tile=tile,
                                  out_dtype=JAX_DT[out])
    _same_bytes(b, br)
    _same_bytes(s, sr)


@pytest.mark.parametrize("out", [None, "int8", "bfloat16"])
@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,tile", PACK_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_pack_against_interpreted_pallas(shape, tile, dtype, out):
    x = _normal(shape, dtype, seed=1)
    b, s = ref.pack_blocks_ref(tensor_from_numpy(x, CPU), tile=tile,
                               out_dtype=TORCH_DT[out])
    bp, sp = jkernel.pack_blocks(jnp.asarray(x), tile=tile,
                                 out_dtype=JAX_DT[out], interpret=True)
    if out == "int8":
        diff = np.abs(b.numpy().astype(np.int32) - np.asarray(bp, np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
    else:
        _same_bytes(b, bp)
    np.testing.assert_allclose(s.numpy(), np.asarray(sp), rtol=1e-6)


@pytest.mark.parametrize("out", [None, "int8"])
def test_pack_and_unpack_match_reference(out):
    y = _normal((3, 1000, 7), seed=2)
    b, s = ops.pack(torch.from_numpy(y), block_bytes=64 << 10,
                    out_dtype=TORCH_DT[out])
    br, sr = jops.pack(jnp.asarray(y), block_bytes=64 << 10,
                       out_dtype=JAX_DT[out], impl="xla")
    _same_bytes(b, br)
    _same_bytes(s, sr)
    back = ops.unpack(b, s, y.shape)
    _same_bytes(back, jops.unpack(br, sr, y.shape))
    if out is None:
        assert torch.equal(back, torch.from_numpy(y))


def test_unpack_respects_non_default_block_bytes():
    y = _normal((64, 192), BF16, seed=3)
    yt = tensor_from_numpy(y, CPU)
    for block_bytes in (8 << 10, 16 << 10, 64 << 10):
        b, s = ops.pack(yt, block_bytes=block_bytes)
        assert b.shape[1] * 2 == block_bytes
        _same_bytes(b, jops.pack(jnp.asarray(y), block_bytes=block_bytes,
                                 impl="xla")[0])
        for kw in (dict(block_bytes=block_bytes), {}):
            out = ops.unpack(b, s, y.shape, dtype=torch.bfloat16, **kw)
            assert torch.equal(out, yt)
    with pytest.raises(ValueError):
        ops.unpack(torch.zeros((2, 100)), torch.ones(2), (200,))


@pytest.mark.parametrize("n", [0, 1, 4096, 5000, 3 * 4096 + 17])
@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
def test_quantize_blocks_matches_reference(n, dtype):
    x = _normal((n,), dtype, seed=4, scale=3.0)
    q, s = ops.quantize_blocks(tensor_from_numpy(x, CPU), block_elems=4096)
    qr, sr = jops.quantize_blocks(jnp.asarray(x), block_elems=4096, impl="xla")
    nb = -(-n // 4096)
    assert q.shape == (nb, 4096) and s.shape == (nb,)
    _same_bytes(q, qr)
    _same_bytes(s, sr)
    back = ops.dequantize_blocks(q, s, n)
    _same_bytes(back, jops.dequantize_blocks(qr, sr, n))
    # |x - dq| <= scale/2 + ulp(x), per block
    xf = x.astype(np.float32)
    lim = np.repeat(s.numpy(), 4096)[:n] / 2 + np.spacing(np.abs(xf))
    assert (np.abs(back.numpy() - xf) <= lim).all()


def test_quantize_blocks_rounds_exact_ties_to_even():
    """amax 127 gives scale 1 exactly, so x / scale lands on .5 ties; they
    go to the even neighbour, as in the reference and numpy's rint."""
    x = np.zeros(4096 + 300, np.float32)
    ties = np.float32([70.5, -70.5, 0.5, 1.5, 2.5, -2.5, 126.5])
    x[:7] = ties
    x[7] = 127.0
    x[4096:4103] = ties * 2          # second block: amax 253, scale 253/127
    x[4103] = -254.0
    q, s = ops.quantize_blocks(torch.from_numpy(x))
    qr, sr = jops.quantize_blocks(jnp.asarray(x), impl="xla")
    _same_bytes(q, qr)
    _same_bytes(s, sr)
    assert s[0] == 1.0
    assert q[0, :7].tolist() == np.rint(ties).astype(int).tolist() == \
        [70, -70, 0, 2, 2, -2, 126]


def test_underflowing_scale_follows_the_host_codec():
    """A block whose amax / 127 underflows to 0 (amax < 127 * 2^-150, as in
    the far tails of the seismic shells) gets the host codec's scale 1 and
    q = 0, and a block whose scale is subnormal keeps it, so the bytes equal
    what the reference sink sends. The reference's XLA path flushes
    subnormals to zero: its scale is 0 for the second block, and its int8
    values there are clipped infinities (a caveat of the reference,
    recorded in ROADMAP)."""
    x = np.zeros(2 * 4096, np.float32)
    x[:3] = np.float32([4e-44, -7e-45, 1.4e-45])   # subnormal, amax/127 -> 0
    x[4096:4099] = np.float32([2e-38, 1e-39, -5e-40])  # quotient subnormal, not 0
    q, s = ops.quantize_blocks(torch.from_numpy(x))
    assert s[0] == 1.0 and not q[0].any() and 0 < s[1] < 1e-39
    payload, _ = RefCodec().encode(x)
    nb = 2
    assert s.numpy().tobytes() == payload[:nb * 4]
    assert q.numpy().reshape(-1).tobytes() == payload[nb * 4:]
    _, sr = jops.quantize_blocks(jnp.asarray(x), impl="xla")
    assert float(sr[1]) == 0.0


def test_quantize_blocks_rejects_block_not_multiple_of_128():
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.quantize_blocks(torch.zeros(10), block_elems=1000)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    before = dict(LAUNCHES)
    x = torch.from_numpy(_normal((5000,), seed=5))
    ops.quantize_blocks(x)
    ops.pack(x, block_bytes=16 << 10, out_dtype=torch.int8)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.pack_blocks(x[:4096].reshape(32, 128), tile=(32, 128),
                           out_dtype=torch.int8)


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float64), "input dtype"),   # float16 is taken
    (dict(out=torch.int32), "out_dtype"),
    (dict(shape=(100, 128)), "whole number"),
    (dict(tile=(8, 6), shape=(64, 6)), "multiple of 4"),
    (dict(strided=True), "contiguous"),
    (dict(n=64 * 129), "do not fit"),
])
def test_kernel_input_checks(bad, match):
    x = torch.zeros(bad.get("n", 64 * 128), dtype=bad.get("dtype", torch.float32))
    if bad.get("strided"):
        x = torch.zeros(2 * 64 * 128)[::2]
    with pytest.raises(ValueError, match=match):
        kernel.check_inputs(x, bad.get("tile", (8, 128)),
                            bad.get("out", torch.int8), bad.get("shape", (64, 128)))


def _encode_both(data, ref_data=None, dtype="uint8"):
    got, meta = Int8BlockCodec().encode(data, dtype=dtype)
    want, want_meta = RefCodec().encode(data if ref_data is None else ref_data,
                                        dtype=dtype)
    return as_bytes_array(got), meta, as_bytes_array(want), want_meta


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, np.int32],
                         ids=["f32", "f64", "f16", "int32"])
@pytest.mark.parametrize("n", [1, 5000, 3 * 4096 + 17])
def test_codec_encodes_numpy_as_the_reference(dtype, n):
    x = _normal((n,), seed=6, scale=5.0)
    x = x.astype(dtype) if dtype != np.int32 else (x * 100).astype(np.int32)
    got, meta, want, want_meta = _encode_both(x)
    assert got.tobytes() == want.tobytes() and meta == want_meta
    # and through the flat uint8 view the Communicator ships
    got, meta, want, want_meta = _encode_both(x.view(np.uint8),
                                              dtype=str(x.dtype))
    assert got.tobytes() == want.tobytes() and meta == want_meta


@pytest.mark.parametrize("dtype", [np.float32, BF16, np.float16, np.float64,
                                   np.int32],
                         ids=["f32", "bf16", "f16", "f64", "int32"])
@pytest.mark.parametrize("n", [0, 1, 5000, 3 * 4096 + 17])
def test_codec_encodes_cpu_tensors_as_the_reference_device_path(dtype, n):
    """A CPU tensor takes the port's tensor path (the kernel's plain
    version); a float32/bfloat16/float16 jax array takes the reference's
    ``_encode_device`` (XLA). float64 and integer tensors take the numpy
    path in the port, as in the reference's host encode."""
    x = _normal((n,), seed=7, scale=3.0)
    x = (x * 100).astype(np.int32) if dtype == np.int32 else x.astype(dtype)
    t = tensor_from_numpy(x, CPU)
    if dtype in (np.float64, np.int32):
        got, meta, want, want_meta = _encode_both(t, ref_data=x)
    else:
        got, meta = Int8BlockCodec().encode(t)
        got = as_bytes_array(got)
        want, want_meta = RefCodec()._encode_device(jnp.asarray(x))
        want = as_bytes_array(want)
    assert got.tobytes() == want.tobytes() and meta == want_meta
    if dtype in (np.float32, np.float16, np.float64) and n:
        back = RefCodec().decode(got, meta).view(dtype)
        ours = Int8BlockCodec().decode(want, want_meta).view(dtype)
        assert back.tobytes() == ours.tobytes()
