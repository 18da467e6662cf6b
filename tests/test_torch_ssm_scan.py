"""Port parity for the selective scan: repro_torch's plain version (what the
wrapper runs on a CPU tensor) against the reference's ``ssm_scan_ref`` and
its Pallas kernel in interpret mode, on the same numpy inputs.

Cases: the reference's three (tests/test_kernels.py) in f32 and in bf16,
the model's mixed types (xi, Bm, Cm bf16; dt f32) and a ragged case (S = 1,
di = 77). Tolerance, per element: |err| <= 1e-5 * (1 + |ref|) for f32
outputs, which both sides' f32 recurrences meet with room (each lies within
1.4e-6 * (1 + |y|) of an f64 evaluation at these shapes); a bf16 y adds one
bf16 step (2**-7 * |ref|), since f32 values a few ulp apart may round to
neighbouring bf16 values. The reference's own ceilings are 5e-5 / 5e-2.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssm_scan import ops as jops  # noqa: E402
from repro.kernels.ssm_scan import ref as jref  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel, ops, ref  # noqa: E402

CPU = torch.device("cpu")
F32, BF16 = np.float32, ml_dtypes.bfloat16


def _inputs(B, S, di, N, x_dt=F32, dt_dt=F32, bc_dt=F32, seed=3):
    """The reference test's distribution: dt = softplus(normal) * 0.1,
    A = -exp(0.2 * normal), h0 normal."""
    r = np.random.default_rng(seed)
    xi = r.standard_normal((B, S, di)).astype(x_dt)
    dt = (np.logaddexp(r.standard_normal((B, S, di)), 0) * 0.1).astype(dt_dt)
    Bm = r.standard_normal((B, S, N)).astype(bc_dt)
    Cm = r.standard_normal((B, S, N)).astype(bc_dt)
    A = -np.exp(r.standard_normal((di, N)) * 0.2).astype(F32)
    h0 = r.standard_normal((B, di, N)).astype(F32)
    return xi, dt, Bm, Cm, A, h0


def _check(got, want, bf16_out):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    lim = 1e-5 * (1 + np.abs(want)) + (2.0 ** -7 * np.abs(want) if bf16_out else 0)
    err = np.abs(got - want)
    assert (err <= lim).all(), float((err / lim).max())


CASES = [  # (B, S, di, N, chunk, d_tile) of the reference's test
    (2, 64, 256, 16, 16, 128),
    (1, 100, 300, 8, 32, 128),
    (2, 128, 512, 16, 64, 256),
]
TYPES = {"f32": (F32, F32, F32), "bf16": (BF16, BF16, BF16)}


def _run_both(a, chunk=64, d_tile=512):
    yt, ht = ops.selective_scan(*(tensor_from_numpy(x, CPU) for x in a))
    ja = [jnp.asarray(x) for x in a]
    y_ref, h_ref = jref.ssm_scan_ref(*ja)
    y_pl, h_pl = jops.selective_scan(*ja, chunk=chunk, d_tile=d_tile,
                                     impl="pallas", interpret=True)
    return (yt, ht), (y_ref, h_ref), (y_pl, h_pl)


@pytest.mark.parametrize("types", sorted(TYPES))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:4])))
def test_plain_scan_matches_reference_and_pallas(case, types):
    B, S, di, N, chunk, d_tile = case
    a = _inputs(B, S, di, N, *TYPES[types])
    (yt, ht), (y_ref, h_ref), (y_pl, h_pl) = _run_both(a, chunk, d_tile)
    bf16 = types == "bf16"
    assert yt.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert ht.dtype == torch.float32
    for want_y, want_h in ((y_ref, h_ref), (y_pl, h_pl)):
        _check(yt, want_y, bf16)
        _check(ht, want_h, False)


@pytest.mark.parametrize("shape", [(2, 96, 200, 16), (3, 1, 77, 16)],
                         ids=["mixed", "ragged_S1_di77"])
def test_plain_scan_mixed_types_and_ragged(shape):
    """The model's types: xi, Bm, Cm bf16 and dt f32 (bf16 + f32 bias)."""
    a = _inputs(*shape, BF16, F32, BF16)
    (yt, ht), (y_ref, h_ref), (y_pl, h_pl) = _run_both(a)
    assert yt.dtype == torch.bfloat16 and yt.shape == shape[:3]
    for want_y, want_h in ((y_ref, h_ref), (y_pl, h_pl)):
        _check(yt, want_y, True)
        _check(ht, want_h, False)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    before = dict(LAUNCHES)
    a = [tensor_from_numpy(x, CPU) for x in _inputs(1, 10, 40, 16)]
    y, h = ops.selective_scan(*a)
    assert LAUNCHES == before and LAUNCHES["ssm_scan"] == before["ssm_scan"]
    assert y.shape == (1, 10, 40) and h.shape == (1, 40, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssm_scan(*a)            # the launcher itself never runs on the CPU


def test_plain_scan_of_empty_sequence_returns_h0():
    a = [tensor_from_numpy(x, CPU) for x in _inputs(2, 0, 8, 4)]
    y, h = ops.selective_scan(*a)
    assert y.shape == (2, 0, 8) and torch.equal(h, a[5])


def test_plain_scan_keeps_no_per_step_state_history():
    """The plain version holds one (B,di,N) state: no (B,S,di,N) tensor, so
    it runs at the serve shape (9.6 GB if it built one)."""
    B, S, di, N = 2, 300, 64, 16
    a = [tensor_from_numpy(x, CPU) for x in _inputs(B, S, di, N)]
    seen = []

    class Spy(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                seen.append(out.numel())
            return out

    with Spy():
        ops.selective_scan(*a)
    assert max(seen) < B * S * di * N // 4


@pytest.mark.parametrize("bad,match", [
    (dict(N=17), "state size"),
    (dict(dt_shape=(1, 5, 8)), "xi, dt"),
    (dict(bc_dtype=torch.float16), "dtypes"),
    (dict(bm_stride=True), "contiguous"),
])
def test_kernel_input_checks(bad, match):
    B, S, di, N = 2, 5, 8, bad.get("N", 4)
    xi = torch.zeros(B, S, di)
    dt = torch.zeros(bad.get("dt_shape", (B, S, di)))
    Bm = torch.zeros(B, S, N, dtype=bad.get("bc_dtype", torch.float32))
    if bad.get("bm_stride"):
        Bm = torch.zeros(B, S, 2 * N)[..., ::2]
    Cm = torch.zeros(B, S, N, dtype=Bm.dtype)
    with pytest.raises(ValueError, match=match):
        kernel.check_inputs(xi, dt, Bm, Cm, torch.zeros(di, N),
                            torch.zeros(B, di, N))


@pytest.mark.parametrize("n", [1, 3, 5, 8, 16])
def test_state_sum_halves_in_a_fixed_order_that_zero_padding_keeps(n):
    """The plain version sums the state by halving, the order the CUDA kernel
    follows with the state padded to 16 entries: padding with zeros to any
    wider power of two gives the same bits."""
    q = torch.from_numpy(np.random.default_rng(n).standard_normal((3, 7, n))
                         .astype(np.float32) * 1e3)
    got = ref.sum_state(q)
    want = q.clone()
    width = 1
    while width < n:
        width *= 2
    want = torch.nn.functional.pad(want, (0, width - n))
    while want.shape[-1] > 1:
        half = want.shape[-1] // 2
        want = want[..., :half] + want[..., half:]
    assert torch.equal(got, want[..., 0])
    for wider in (8, 16, 32):
        if wider >= n:
            padded = torch.nn.functional.pad(q, (0, wider - n))
            assert torch.equal(ref.sum_state(padded), got)
