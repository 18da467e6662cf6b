"""Port parity for the in-transit egress path: the port's SeismicField,
InTransitSink, TransferSession, staging and SAVIME against the reference's,
on the CPU, with the same values.

End to end, the example's mesh (31x64x64), 3 steps plus a small tree, with
codec none and int8-block, decoded at staging and at query: the port's sink
into the reference's servers, the reference's sink into the port's servers
and port into port must each leave what reference into reference leaves,
byte for byte: every SAVIME TAR (name, dimensions, attributes, subtars and
their bytes), the DDL statements SAVIME ran (TAR and dataset names), and the
sender's raw and wire byte counts. Every test stops its servers.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as rcore  # noqa: E402
import repro.transport as rtransport  # noqa: E402
import repro_torch.core as pcore  # noqa: E402
import repro_torch.transport as ptransport  # noqa: E402
from repro.data.seismic import SeismicConfig as RefSeismicConfig  # noqa: E402
from repro.data.seismic import SeismicField as RefSeismicField  # noqa: E402
from repro_torch.data.seismic import SeismicConfig, SeismicField  # noqa: E402
from _torch_crossings import savime_contents as _savime_contents  # noqa: E402

CORE = {"ref": rcore, "port": pcore}
MESH = dict(nx=31, ny=64, nz=64)
N_STEPS = 3


@pytest.mark.parametrize("t", [0, 4, 11])
def test_seismic_field_matches_reference(t):
    ours = SeismicField(SeismicConfig(**MESH), device="cpu").step(t)
    want = RefSeismicField(RefSeismicConfig(**MESH)).step(t)
    assert ours.dtype == torch.float64 and ours.shape == want.shape
    # torch's exp and sqrt against numpy's: within 1e-12 relative, except
    # in the subnormal range (the shells' far tails), where a double keeps
    # fewer significant bits: there within the smallest normal double
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-12,
                               atol=np.finfo(np.float64).tiny)


def test_seismic_field_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SeismicField(SeismicConfig(**MESH))


@functools.cache
def _fields() -> tuple:
    f = RefSeismicField(RefSeismicConfig(**MESH))
    return tuple(f.step(t).astype(np.float32) for t in range(N_STEPS))


def _tree(step: int, as_tensor: bool) -> dict:
    r = np.random.default_rng(step)
    leaves = {"loss": r.standard_normal(1).astype(np.float32),
              "grad/norm": r.standard_normal((3, 5)).astype(np.float32),
              "tok.count": np.arange(4, dtype=np.int64) + step}
    if as_tensor:
        leaves = {k: torch.from_numpy(v) for k, v in leaves.items()}
    return {"diag": leaves, "lr": leaves["loss"] * 0}


def _run(sink_pkg: str, server_pkg: str, codec: str, decode_at: str) -> dict:
    servers = CORE[server_pkg]
    sv = servers.SavimeServer().start()
    ddl = []
    run = sv.engine.run

    def recording_run(q):
        ddl.append(q)
        return run(q)

    sv.engine.run = recording_run
    st = servers.StagingServer(sv.addr, mem_capacity=64 << 20).start()
    try:
        sinks = CORE[sink_pkg]
        sink = sinks.InTransitSink(st.addr, sinks.InTransitConfig(
            tar_prefix="sim", codec=codec, decode_at=decode_at))
        try:
            port = sink_pkg == "port"
            for step, field in enumerate(_fields()):
                sink.stage_array("velocity",
                                 torch.from_numpy(field) if port else field,
                                 step=step)
                sink.stage_tree("t_", _tree(step, port), step=step)
            sink.flush(timeout=30)
            codec_stats = dict(sink.session.stats.codec)
            codec_stats.pop("encode_s", None)
            staged = (sink.staged_bytes, sink.staged_arrays)
        finally:
            sink.close()
        contents = _savime_contents(sv)
    finally:
        st.stop()
        sv.stop()
    return {"contents": contents, "ddl": ddl, "codec": codec_stats,
            "staged": staged}


@functools.cache
def _reference(codec: str, decode_at: str) -> dict:
    return _run("ref", "ref", codec, decode_at)


@pytest.mark.parametrize("decode_at", ["staging", "query"])
@pytest.mark.parametrize("codec", ["none", "int8-block"])
@pytest.mark.parametrize("sink,servers", [("port", "ref"), ("ref", "port"),
                                          ("port", "port")],
                         ids=["port_sink-ref_servers", "ref_sink-port_servers",
                              "port_sink-port_servers"])
def test_sink_leaves_the_reference_savime_contents(sink, servers, codec,
                                                   decode_at):
    want = _reference(codec, decode_at)
    got = _run(sink, servers, codec, decode_at)
    assert got["ddl"] == want["ddl"]
    assert got["contents"].keys() == want["contents"].keys()
    for name in want["contents"]:
        assert got["contents"][name] == want["contents"][name], name
    assert got["codec"] == want["codec"] and got["staged"] == want["staged"]
    tars = [k for k in want["contents"] if not k.startswith("__")]
    assert {"sim_velocity", "sim_t_diaggrad_norm", "sim_t_diagtok_count",
            "sim_t_diagloss", "sim_t_lr"} <= set(tars)
    if codec == "int8-block":
        assert want["codec"]["fallbacks"] == 0
        assert 0.25 < want["codec"]["wire_bytes"] / want["codec"]["raw_bytes"] < 0.3


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_session_encodes_a_tensor_as_the_reference_encodes_its_array(dtype):
    """A tensor written through the port's TransferSession reaches the
    central encode as it is (the codec's tensor path, here the kernel's
    plain version on the CPU) and lands in SAVIME as the reference's
    session lands the same values from numpy."""
    x = (np.random.default_rng(9).standard_normal(3 * 4096 + 17) * 4
         ).astype(dtype)
    landed = {}
    for pkg, transport, data in (("ref", rtransport, x),
                                 ("port", ptransport, torch.from_numpy(x))):
        sv = rcore.SavimeServer().start()
        st = rcore.StagingServer(sv.addr, mem_capacity=16 << 20).start()
        try:
            cfg = transport.TransportConfig(staging_addr=st.addr,
                                            codec="int8-block")
            with transport.TransferSession("rdma_staged", cfg) as sess:
                sess.write("D", data, dtype=np.dtype(dtype).name)
                sess.sync(30)
                sess.drain(30)
            landed[pkg] = (sv.engine.datasets["D"].tobytes(),
                           {k: v for k, v in sess.stats.codec.items()
                            if k != "encode_s"})
        finally:
            st.stop()
            sv.stop()
    assert landed["port"] == landed["ref"]
    assert landed["port"][1]["datasets"] == 1


def test_session_copies_a_tensor_to_the_host_without_a_codec():
    x = np.arange(10, dtype=np.float32)
    sv = pcore.SavimeServer().start()
    st = pcore.StagingServer(sv.addr, mem_capacity=16 << 20).start()
    try:
        cfg = ptransport.TransportConfig(staging_addr=st.addr)
        with ptransport.TransferSession("rdma_staged", cfg) as sess:
            sess.write("D", torch.from_numpy(x))
            sess.sync(30)
            sess.drain(30)
            with pytest.raises(ValueError, match="host buffers"):
                sess.write("E", torch.from_numpy(x), nbytes=8)
        ds = sv.engine.datasets["D"]
        assert ds.dtype == np.float32 and ds.tobytes() == x.tobytes()
    finally:
        st.stop()
        sv.stop()


def test_stage_tree_names_leaves_as_the_reference():
    import jax

    from repro_torch.core.intransit import _flatten_with_path
    tree = {"b": [np.zeros(1), None, {"x.y": np.ones(2)}], "a": np.zeros(3),
            "c": (np.zeros(1), 2.0)}
    ours = [(path, leaf) for path, leaf in _flatten_with_path(tree)]
    theirs = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in ours] == [
        tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p)
        for p, _ in theirs]
    assert all(a is b for (_, a), (_, b) in zip(ours, theirs))


# -- bfloat16 ------------------------------------------------------------------
# The port holds a bfloat16 value as its bits in uint16 (repro_torch.tensors);
# the reference as an ml_dtypes bfloat16, which numpy has only while jax (and
# so ml_dtypes) is loaded. These tests load jax, so the matrix that must work
# without it runs in a subprocess that blocks jax, jaxlib, ml_dtypes and repro.
BF16_CASES = [("none", "none"), ("none", "int8"), ("int8-block", "none"),
              ("int8-block", "int8")]


@functools.cache
def _bf16_matrix_without_jax() -> dict:
    from _torch_bf16_staging import run
    return {(r["codec"], r["quantize"]): r for r in run("cpu")}


@pytest.mark.parametrize("codec,quantize", BF16_CASES)
def test_bf16_tensor_stages_without_jax(codec, quantize):
    """8197 bf16 values of linspace(-2, 2): SAVIME holds their bits (2 bytes
    a value) under attribute type "bfloat16", and a query gives them back
    widened to float32, exactly, in a process where numpy has no bfloat16."""
    r = _bf16_matrix_without_jax()[(codec, quantize)]
    assert r["imported"] == []
    assert r["tars"] == ["s_a"] and not r["packed"] and r["launches"] == 0
    assert r["attr"] == ["bfloat16", [1_000_000, 8196]]
    assert r["held"] == ["uint16", [1, 8197]] and r["bits_equal"]
    assert r["query"] == ["float32", [1, 8197]] and r["query_equal"]
    assert r["max_err"] == 0.0


def _bf16_values():
    import ml_dtypes
    x = torch.linspace(-2, 2, 8197, dtype=torch.bfloat16)
    return x, x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _run_bf16(sink_pkg: str, server_pkg: str, codec: str, quantize: str) -> dict:
    servers = CORE[server_pkg]
    sv = servers.SavimeServer().start()
    ddl = []
    run = sv.engine.run

    def recording_run(q):
        ddl.append(q)
        return run(q)

    sv.engine.run = recording_run
    st = servers.StagingServer(sv.addr, mem_capacity=16 << 20).start()
    try:
        sinks = CORE[sink_pkg]
        sink = sinks.InTransitSink(st.addr, sinks.InTransitConfig(
            tar_prefix="s", codec=codec, quantize=quantize))
        try:
            tensor, array = _bf16_values()
            sink.stage_array("a", tensor if sink_pkg == "port" else array)
            sink.flush(timeout=30)
            staged = (sink.staged_bytes, sink.staged_arrays)
        finally:
            sink.close()
        contents = _savime_contents(sv)
    finally:
        st.stop()
        sv.stop()
    return {"contents": contents, "ddl": ddl, "staged": staged}


@pytest.mark.parametrize("servers", ["ref", "port"])
@pytest.mark.parametrize("codec,quantize", BF16_CASES)
def test_bf16_sink_leaves_the_reference_bytes_and_ddl(codec, quantize, servers):
    """The port's sink with a bf16 CPU tensor and the reference's sink with
    the same values as a numpy bfloat16 array, into the same servers: the
    same DDL, the same TAR and the same bytes (2 a value, unquantized: the
    reference does not quantize or block-encode a bfloat16 array)."""
    want = _run_bf16("ref", servers, codec, quantize)
    got = _run_bf16("port", servers, codec, quantize)
    assert got == want
    dims, attrs, subs = want["contents"]["s_a"]
    assert attrs == [("v", "bfloat16")] and want["staged"] == (2 * 8197, 1)
    assert subs[0][2][0][2] == _bf16_values()[1].tobytes()


def test_bf16_decode_matches_the_reference():
    """A bf16 tensor's int8-block payload (the kernel's plain version, as on
    the card) decodes to the same bytes in the port, which rounds float32 to
    bf16 with integer arithmetic, and in the reference (ml_dtypes)."""
    from repro.codec.int8block import Int8BlockCodec as RefCodec
    from repro_torch.codec.int8block import Int8BlockCodec
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(3 * 4096 + 5)
                         .astype(np.float32) * 7).to(torch.bfloat16)
    payload, meta = Int8BlockCodec().encode(x)
    assert meta["dtype"] == "bfloat16"
    ours = Int8BlockCodec().decode(payload, meta)
    theirs = RefCodec().decode(bytes(memoryview(payload)), meta)
    assert ours.tobytes() == theirs.tobytes() and ours.size == 2 * x.numel()


def test_tensor_bits_round_trip_as_torch_rounds():
    from repro_torch.tensors import bf16_to_f32, f32_to_bf16, to_host
    f = np.random.default_rng(4).standard_normal(10_000).astype(np.float32)
    f[:6] = [np.inf, -np.inf, 0.0, -0.0, 3.4e38, 1.5e-45]
    want = to_host(torch.from_numpy(f).to(torch.bfloat16))
    assert want.dtype == np.uint16
    assert np.array_equal(f32_to_bf16(f), want)
    assert np.array_equal(bf16_to_f32(want),
                          torch.from_numpy(f).to(torch.bfloat16).float().numpy())
    assert np.isnan(bf16_to_f32(f32_to_bf16(np.float32([np.nan])))).all()


def test_a_replay_sends_the_tensor_as_it_stands_then():
    """The journal holds the written tensor itself, not a copy (the buffer
    contract of TransferSession.write and InTransitSink.stage_array): when
    the first attempt fails and the caller has mutated the tensor in place
    meanwhile, the replay encodes and lands the mutated values."""
    from repro_torch.codec.int8block import Int8BlockCodec
    from repro_torch.core.queues import TaskHandle
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(2 * 4096)
                         .astype(np.float32))
    sv = pcore.SavimeServer().start()
    st = pcore.StagingServer(sv.addr, mem_capacity=16 << 20).start()
    try:
        cfg = ptransport.TransportConfig(staging_addr=st.addr,
                                         codec="int8-block")
        with ptransport.TransferSession("rdma_staged", cfg) as sess:
            real = sess.transport.write_epoch
            first = TaskHandle(None, (), "first attempt")
            replays = []

            def write_epoch(name, dtype, buf, epoch, replay=False):
                if not replay:
                    return first          # held open: settled below
                replays.append(buf)
                return real(name, dtype, buf, epoch, replay=replay)

            sess.transport.write_epoch = write_epoch
            sess.write("D", x)
            x.mul_(-2)                    # mutated before the replay
            first.complete(error=ConnectionError("connection lost"))
            sess.sync(30)
            sess.drain(30)
            assert sess.stats.replays == 1 and replays[0] is not None
            assert replays[0].data_ptr() == x.data_ptr()
        codec = Int8BlockCodec()
        want = codec.decode(*codec.encode(x.numpy()))
        assert sv.engine.datasets["D"].tobytes() == want.tobytes()
    finally:
        st.stop()
        sv.stop()


def test_savime_computes_on_bf16_values_not_their_bits():
    """A bf16 attribute is held as uint16 bits; aggregates, filters and a
    client's select see the values (widened to float32)."""
    from repro_torch.analysis import AnalysisSession, tar
    from repro_torch.analysis.query import CreateTar
    from repro_torch.core.tars import Attribute, Dimension
    from repro_torch.tensors import f32_to_bf16
    vals = np.float32([1.5, -2.0, 0.25, 3.0])
    sv = pcore.SavimeServer().start()
    try:
        eng = sv.engine
        eng.run(CreateTar("t", (Dimension("i", 0, 3),),
                          (Attribute("v", "bfloat16"),)).compile())
        eng.tars["t"].load_subtar((0,), (4,), {"v": f32_to_bf16(vals)})
        assert eng.tars["t"].select("v").dtype == np.uint16
        assert eng.tars["t"].aggregate("v", "sum") == 2.75
        assert eng.tars["t"].filter("v", lambda b: b > 1)[:, 1].tolist() == [1.5, 3.0]
        with AnalysisSession(sv.addr) as an:
            got = an.execute(tar("t").attr("v").select()).array
            assert got.dtype == np.float32 and got.tolist() == vals.tolist()
            assert an.execute(tar("t").attr("v").aggregate("max")).scalar == 3.0
    finally:
        sv.stop()
