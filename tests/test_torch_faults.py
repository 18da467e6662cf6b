"""Port parity for the fault harness, on the CPU.

The port's FaultPlan parses and encodes the reference's specs as the
reference does, and its injector fires on the same frames (and corrupts
the same bytes) for the same seed. Installed on the wire of the package
whose client runs, a dropped stripe (adopted by the surviving channel) and
a dropped stripe_open (replayed from the session's journal) each leave
what the reference's clean run leaves in SAVIME, byte for byte, in every
crossing. A replayed write encodes a tensor again. Every rule is an
``nth=`` or ``every=`` trigger or a seeded ``prob=``; nothing depends on
the wall clock.
"""
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.faults as rfaults  # noqa: E402
import repro.transport as rtransport  # noqa: E402
import repro_torch.faults as pfaults  # noqa: E402
import repro_torch.transport as ptransport  # noqa: E402
from _torch_crossings import (CORE, CROSSING_IDS, CROSSINGS, STRIPE,  # noqa: E402
                              fields, recording_ddl, savime_contents,
                              stage_steps)

FAULTS = {"ref": rfaults, "port": pfaults}
TRANSPORT = {"ref": rtransport, "port": ptransport}
SPECS = [
    "seed=42;drop:op=stripe,prob=0.01;kill:target=staging:0,at_s=0.5",
    "seed=7;drop:op=stripe,nth=5",
    "seed=11;corrupt:op=stripe,prob=0.05,flips=3",
    "seed=3;drop:op=write_req,nth=2;delay:op=batch_write,every=2,delay_s=0.01",
    "dup:peer=127.0.0.1:9,every=3;partition:peer=:9,duration_s=1.5",
    "",
]
BAD_SPECS = ["explode:prob=1.0", "kill:at_s=1.0", "drop:bogus=3"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parses_as_the_reference(spec, tmp_path):
    ours, theirs = pfaults.FaultPlan.parse(spec), rfaults.FaultPlan.parse(spec)
    assert ours.encode() == theirs.encode()
    assert [r.kind for r in ours.wire_rules] == [r.kind for r in theirs.wire_rules]
    assert [r.kind for r in ours.kill_rules] == [r.kind for r in theirs.kill_rules]
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(theirs.encode()))
    assert pfaults.FaultPlan.parse(str(p)).encode() == theirs.encode()
    assert rfaults.FaultPlan.decode(ours.encode()).encode() == theirs.encode()


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_plan_rejects_as_the_reference(spec):
    with pytest.raises(ValueError) as ours:
        pfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as theirs:
        rfaults.FaultPlan.parse(spec)
    assert str(ours.value) == str(theirs.value)


def _firings(faults, spec: str) -> list:
    """Which of 300 frames (mixed ops and peers) each rule fires on, and
    the bytes a corrupt rule leaves in a payload each time it fires."""
    inj = faults.FaultInjector(faults.FaultPlan.parse(spec))
    ops = ("stripe", "write_req", "stripe", "batch_write", None)
    out = []
    for i in range(300):
        peer = f"127.0.0.1:{9 if i % 4 else 8}"
        rule = inj._decide(peer, {"op": ops[i % len(ops)]})
        if rule is None:
            continue
        out.append((i, rule.kind))
        if rule.kind == "corrupt":
            out.append(bytes(inj._corrupt(bytes(range(64)) * 4, rule.flips)))
    return out + [sorted(inj.fired.items())]


@pytest.mark.parametrize("spec", [
    "seed=9;corrupt:op=stripe,prob=0.3,flips=2",
    "seed=10;corrupt:op=stripe,prob=0.3;drop:prob=0.05",
    "seed=1;drop:op=stripe,nth=3;delay:every=7;dup:peer=:8,every=2",
    "seed=4;corrupt:nth=2;corrupt:nth=1;corrupt:peer=:9,prob=0.5,flips=5",
])
def test_injector_fires_on_the_same_frames(spec):
    ours = _firings(pfaults, spec)
    assert ours == _firings(rfaults, spec)
    assert len(ours) > 1


def test_install_hooks_the_port_wire_only():
    from repro.core import wire as rwire
    from repro_torch.core import wire as pwire
    with pfaults.injected(pfaults.FaultPlan.parse("seed=1")) as inj:
        assert pwire._FAULT_INJECTOR is inj
        assert rwire._FAULT_INJECTOR is None
    assert pwire._FAULT_INJECTOR is None


# -- a dropped stripe: the survivors adopt it ------------------------------

STRIPED = dict(n_channels=2, stripe_bytes=STRIPE)


def _striped_run(sink_pkg: str, server_pkg: str, codec: str,
                 spec: str = "") -> dict:
    servers = CORE[server_pkg]
    sv = servers.SavimeServer().start()
    ddl = recording_ddl(sv)
    st = servers.StagingServer(sv.addr, mem_capacity=64 << 20).start()
    try:
        faults = FAULTS[sink_pkg]
        with faults.injected(faults.FaultPlan.parse(spec),
                             scope=[st.addr]) as inj:
            got = stage_steps(sink_pkg, st.addr, codec=codec, **STRIPED)
        contents = savime_contents(sv)
    finally:
        st.stop()
        sv.stop()
    return {"contents": contents, "ddl": ddl, "codec": got["codec"],
            "staged": got["staged"], "fired": dict(inj.fired),
            "adopted": sum(c["adopted"] for c in got["channels"]),
            "replays": got["replays"]}


@functools.cache
def _clean_reference(codec: str) -> dict:
    return _striped_run("ref", "ref", codec)


@pytest.mark.parametrize("codec", ["none", "int8-block"])
@pytest.mark.parametrize("sink,servers", CROSSINGS, ids=CROSSING_IDS)
def test_dropped_stripe_leaves_the_reference_contents(sink, servers, codec):
    """drop:op=stripe,nth=3 severs one channel mid-dataset: its stripes
    are re-sent on the other, and SAVIME holds what the clean run holds."""
    want = _clean_reference(codec)
    got = _striped_run(sink, servers, codec, "seed=42;drop:op=stripe,nth=3")
    assert got["fired"] == {"drop": 1} and want["fired"] == {}
    assert got["replays"] + got["adopted"] >= 1
    assert got["ddl"] == want["ddl"]
    assert got["contents"] == want["contents"]
    assert got["codec"] == want["codec"] and got["staged"] == want["staged"]


# -- a dropped stripe_open: the session's journal replays the write ---------

def _replay_run(sink_pkg: str, server_pkg: str, codec: str,
                spec: str) -> dict:
    """One field through a striped session with no per-write retries: a
    dropped stripe_open fails the write and the journal replays it."""
    x = fields()[1]
    data = torch.from_numpy(x.copy()) if sink_pkg == "port" else x
    servers, tp, faults = CORE[server_pkg], TRANSPORT[sink_pkg], FAULTS[sink_pkg]
    sv = servers.SavimeServer().start()
    st = servers.StagingServer(sv.addr, mem_capacity=64 << 20).start()
    try:
        with faults.injected(faults.FaultPlan.parse(spec),
                             scope=[st.addr]) as inj:
            cfg = tp.TransportConfig(staging_addr=st.addr, codec=codec,
                                     retry=0, **STRIPED)
            with tp.TransferSession("rdma_staged", cfg) as sess:
                fut = sess.write("D", data, dtype="float32")
                sess.sync(60)
                sess.drain(60)
                assert fut.done()
        held = sv.engine.datasets["D"]
    finally:
        st.stop()
        sv.stop()
    codec_stats = {k: v for k, v in sess.stats.codec.items() if k != "encode_s"}
    return {"held": (held.dtype.str, held.tobytes()), "fired": dict(inj.fired),
            "replays": sess.stats.replays, "codec": codec_stats}


@pytest.mark.parametrize("codec", ["none", "int8-block"])
@pytest.mark.parametrize("sink,servers", CROSSINGS, ids=CROSSING_IDS)
def test_journal_replay_leaves_the_reference_contents(sink, servers, codec,
                                                      monkeypatch):
    from repro_torch.kernels.staging_pack import ops
    packs = []
    real = ops.quantize_blocks
    monkeypatch.setattr(ops, "quantize_blocks",
                        lambda *a, **kw: packs.append(1) or real(*a, **kw))
    want = _replay_run("ref", "ref", codec, "")
    got = _replay_run(sink, servers, codec, "seed=5;drop:op=stripe_open,nth=1")
    assert got["fired"] == {"drop": 1} and got["replays"] == 1
    assert want["replays"] == 0
    assert got["held"] == want["held"]
    if codec == "none":
        assert got["held"][1] == fields()[1].tobytes()
        assert got["codec"] == want["codec"] == {}
    else:
        # the replay encodes the write again: one more dataset encoded
        assert got["codec"]["datasets"] == 2 and want["codec"]["datasets"] == 1
    # a port tensor under int8-block goes through the staging_pack path,
    # once for the write and once for its replay
    assert len(packs) == (2 if sink == "port" and codec == "int8-block" else 0)


def _pool_harness_run(pkg: str) -> dict:
    import repro.analysis as ranalysis
    import repro.gateway as rgateway
    import repro_torch.analysis as panalysis
    import repro_torch.gateway as pgateway
    gw = {"ref": rgateway, "port": pgateway}[pkg]
    analysis = {"ref": ranalysis, "port": panalysis}[pkg]
    pool = gw.StagingPool(2, mem_capacity=64 << 20).start()
    try:
        plan = FAULTS[pkg].FaultPlan.parse("seed=2;drop:op=stripe,nth=3")
        with pool.with_faults(plan) as harness:
            got = stage_steps(pkg, pool.addr, gateway=True, **STRIPED)
        with gw.RouterSession(gateway_addr=pool.addr) as rs:
            back = rs.execute(analysis.tar("sim_velocity").attr("v")
                              .select()).array
    finally:
        pool.stop()
    return {"staged": got["staged"], "fired": dict(harness.injector.fired),
            "killed": harness.scheduler.killed, "back": back.tobytes()}


def test_pool_fault_harness_as_the_reference():
    """``StagingPool.with_faults``: each package's pool harness with its own
    client, a stripe dropped on the way to a backend; both land the same
    steps, gathered whole through a RouterSession."""
    ours, theirs = _pool_harness_run("port"), _pool_harness_run("ref")
    assert ours == theirs
    assert ours["fired"] == {"drop": 1} and ours["killed"] == []
    assert ours["back"] == b"".join(f.tobytes() for f in fields())


# -- a dropped batch_write: only that batch replays -------------------------

def _coalesced_run(sink_pkg: str, server_pkg: str, spec: str) -> dict:
    """30 small datasets, coalesced three to a batch (a sync after every
    third write; the linger window is too long to flush on its own)."""
    servers, tp, faults = CORE[server_pkg], TRANSPORT[sink_pkg], FAULTS[sink_pkg]
    rng = np.random.default_rng(6)
    bufs = [rng.standard_normal(16).astype(np.float32) for _ in range(30)]
    sv = servers.SavimeServer().start()
    st = servers.StagingServer(sv.addr, mem_capacity=16 << 20).start()
    try:
        with faults.injected(faults.FaultPlan.parse(spec),
                             scope=[st.addr]) as inj:
            cfg = tp.TransportConfig(staging_addr=st.addr,
                                     coalesce_bytes=STRIPE, linger_ms=60_000)
            with tp.TransferSession("rdma_staged", cfg) as sess:
                for i, b in enumerate(bufs):
                    sess.write(f"c{i}", torch.from_numpy(b)
                               if sink_pkg == "port" else b)
                    if i % 3 == 2:
                        sess.sync(60)
        held = [sv.engine.datasets[f"c{i}"].tobytes() for i in range(30)]
    finally:
        st.stop()
        sv.stop()
    return {"held": held, "fired": dict(inj.fired),
            "replays": sess.stats.replays, "want": [b.tobytes() for b in bufs]}


@pytest.mark.parametrize("sink,servers", CROSSINGS, ids=CROSSING_IDS)
def test_dropped_batch_write_replays_only_its_batch(sink, servers):
    """drop:op=batch_write,nth=2 fails the second batch; its three datasets
    replay one by one and every dataset lands. The port's coalescer drops
    the broken connection, so no later batch fails; the reference's keeps
    it, and every later batch fails and replays too (the 8 that follow)."""
    got = _coalesced_run(sink, servers, "seed=7;drop:op=batch_write,nth=2")
    assert got["fired"] == {"drop": 1}
    assert got["held"] == got["want"]
    assert got["replays"] == (3 if sink == "port" else 3 + 8 * 3)
