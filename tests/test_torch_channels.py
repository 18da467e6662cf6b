"""Port parity for striped channels, coalescing and the scp/ssh copy
baselines, on the CPU, with the same values.

Each feature stages the example's mesh (31x64x64, 2 steps, each a ragged
7.75 stripes of 64 KiB) and a small tree a step through an InTransitSink
with codec none and int8-block. The port's sink into the reference's
servers, the reference's sink into the port's servers and port into port
must each leave what reference into reference leaves, byte for byte: every
SAVIME TAR, the DDL SAVIME ran, the sender's codec stats and staged counts,
and the staging server's stripe and coalescing counters. Every test stops
its servers, and none asserts on the wall clock.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.transport as rtransport  # noqa: E402
import repro_torch.transport as ptransport  # noqa: E402
from _torch_crossings import (CORE, CROSSING_IDS, CROSSINGS, STRIPE,  # noqa: E402
                              fields, recording_ddl, savime_contents,
                              stage_steps)

TRANSPORT = {"ref": rtransport, "port": ptransport}
COPY_ENGINES = ("scp_mem", "scp_disk", "ssh_direct")
FEATURES = {
    "stripes2": dict(n_channels=2, stripe_bytes=STRIPE),
    "stripes3": dict(n_channels=3, stripe_bytes=STRIPE),
    "coalesce": dict(coalesce_bytes=STRIPE),
    "stripes2+coalesce": dict(n_channels=2, stripe_bytes=STRIPE,
                              coalesce_bytes=STRIPE),
    **{e: dict(transport=e) for e in COPY_ENGINES},
    "scp_mem+stripes2": dict(transport="scp_mem", n_channels=2,
                             stripe_bytes=STRIPE),
}
STAGING_COUNTERS = ("datasets", "stripes", "batched_datasets", "codec_datasets")


def _run(sink_pkg: str, server_pkg: str, feature: str, codec: str) -> dict:
    cfg = dict(FEATURES[feature], codec=codec)
    servers = CORE[server_pkg]
    sv = servers.SavimeServer().start()
    ddl = recording_ddl(sv)
    st = None
    try:
        if cfg.get("transport", "rdma_staged") == "rdma_staged":
            st = servers.StagingServer(sv.addr, mem_capacity=64 << 20).start()
        got = stage_steps(sink_pkg, st.addr if st else sv.addr, **cfg)
        contents = savime_contents(sv)
    finally:
        if st is not None:
            st.stop()
        sv.stop()
    counters = {k: st.stats[k] for k in STAGING_COUNTERS} if st else {}
    return {"contents": contents, "ddl": ddl, "codec": got["codec"],
            "staged": got["staged"], "counters": counters,
            "n_channels": len(got["channels"]),
            "striped_channels": sum(c["n_stripes"] > 0 for c in got["channels"])}


@functools.cache
def _reference(feature: str, codec: str) -> dict:
    return _run("ref", "ref", feature, codec)


@pytest.mark.parametrize("codec", ["none", "int8-block"])
@pytest.mark.parametrize("feature", list(FEATURES))
@pytest.mark.parametrize("sink,servers", CROSSINGS, ids=CROSSING_IDS)
def test_feature_leaves_the_reference_savime_contents(sink, servers, feature,
                                                      codec):
    want = _reference(feature, codec)
    got = _run(sink, servers, feature, codec)
    assert got["ddl"] == want["ddl"]
    assert got["contents"].keys() == want["contents"].keys()
    for name in want["contents"]:
        assert got["contents"][name] == want["contents"][name], name
    assert got["codec"] == want["codec"] and got["staged"] == want["staged"]
    assert got["counters"] == want["counters"]
    assert got["n_channels"] == want["n_channels"]
    cfg = FEATURES[feature]
    n_ch = cfg.get("n_channels", 1)
    if n_ch > 1:                       # every channel carried stripes
        assert got["n_channels"] == got["striped_channels"] == n_ch
    if cfg.get("transport") in COPY_ENGINES:
        # the codec is inert on a baseline: raw bytes, no codec stats
        assert want["codec"] == {}
        held = want["contents"]["sim_velocity"][2]
        assert [s[2][0][2] for s in held] == [f.tobytes() for f in fields()]
        return
    c = want["counters"]
    n_small = c["datasets"] - 2        # every tree leaf is below 64 KiB
    if cfg.get("coalesce_bytes"):
        assert c["batched_datasets"] == n_small > 0
    else:
        assert c["batched_datasets"] == 0
    if n_ch > 1 and codec == "none":
        # the field's 507,904 B in 64 KiB stripes: 7 full and a ragged one
        field_stripes = -(-fields()[0].nbytes // STRIPE)
        assert fields()[0].nbytes % STRIPE
        small = 0 if cfg.get("coalesce_bytes") else n_small
        assert c["stripes"] == 2 * field_stripes + small
    if codec == "int8-block":
        assert want["codec"]["fallbacks"] == 0
        assert c["codec_datasets"] == want["codec"]["datasets"] > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64],
                         ids=["f32", "f16", "i64"])
@pytest.mark.parametrize("engine", COPY_ENGINES)
def test_copy_engine_lands_a_tensor_as_the_reference_lands_its_array(
        engine, dtype):
    """A CPU tensor written through the port's session on a copy baseline,
    with codec int8-block set, lands in SAVIME as the reference's session
    lands the same numpy array: raw bytes under the same dtype, and no
    codec stats on either side."""
    x = (np.random.default_rng(2).standard_normal(3 * 4096 + 17) * 50
         ).astype(dtype)
    landed = {}
    for pkg, data in (("ref", x), ("port", torch.from_numpy(x))):
        sv = CORE["ref"].SavimeServer().start()
        try:
            tp = TRANSPORT[pkg]
            cfg = tp.TransportConfig(savime_addr=sv.addr, codec="int8-block")
            with tp.TransferSession(engine, cfg) as sess:
                sess.write("D", data)
                sess.sync(30)
                sess.drain(30)
            ds = sv.engine.datasets["D"]
            landed[pkg] = (ds.dtype.str, ds.tobytes(), sess.stats.codec)
        finally:
            sv.stop()
    assert landed["port"] == landed["ref"]
    assert landed["port"][1] == x.tobytes() and landed["port"][2] == {}


def test_copy_engine_never_packs_a_tensor(monkeypatch):
    """The codec is inert on the baselines: a tensor written with codec
    int8-block is copied to the host as it is; the staging_pack path
    (the kernel on the card) is never reached."""
    from repro_torch.kernels.staging_pack import ops
    calls = []
    real = ops.quantize_blocks
    monkeypatch.setattr(ops, "quantize_blocks",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = torch.linspace(-3, 3, 2 * 4096 + 5)
    for engine in COPY_ENGINES:
        sv = CORE["port"].SavimeServer().start()
        try:
            cfg = ptransport.TransportConfig(savime_addr=sv.addr,
                                             codec="int8-block")
            with ptransport.TransferSession(engine, cfg) as sess:
                sess.write("D", x)
            assert sv.engine.datasets["D"].tobytes() == x.numpy().tobytes()
        finally:
            sv.stop()
    assert calls == []
    # the staged path with the same config does reach it, once
    sv = CORE["port"].SavimeServer().start()
    st = CORE["port"].StagingServer(sv.addr, mem_capacity=16 << 20).start()
    try:
        cfg = ptransport.TransportConfig(staging_addr=st.addr,
                                         codec="int8-block", n_channels=2)
        with ptransport.TransferSession("rdma_staged", cfg) as sess:
            sess.write("D", x)
    finally:
        st.stop()
        sv.stop()
    assert calls == [1]


@functools.cache
def _bf16_copy_engines_without_jax() -> dict:
    from _torch_bf16_staging import run
    return {(r["transport"], r["codec"], r["quantize"]): r
            for r in run("cpu", transports=COPY_ENGINES)}


@pytest.mark.parametrize("codec,quantize", [("none", "none"),
                                            ("int8-block", "none"),
                                            ("int8-block", "int8")])
@pytest.mark.parametrize("engine", COPY_ENGINES)
def test_bf16_tensor_through_a_copy_engine_without_jax(engine, codec,
                                                       quantize):
    """A bf16 tensor through each copy baseline in a process with no jax
    or ml_dtypes: SAVIME holds the values' bits under type "bfloat16", the
    bytes the reference's numpy bfloat16 array would land."""
    r = _bf16_copy_engines_without_jax()[(engine, codec, quantize)]
    assert r["imported"] == []
    assert r["tars"] == ["s_a"] and not r["packed"] and r["launches"] == 0
    assert r["attr"] == ["bfloat16", [1_000_000, 8196]]
    assert r["held"] == ["uint16", [1, 8197]] and r["bits_equal"]
    assert r["query"] == ["float32", [1, 8197]] and r["query_equal"]
    assert r["max_err"] == 0.0
