"""Port parity for the staging gateway and pool with tenancy, on the CPU,
with the same values.

A two-backend StagingPool with a tenant holding a quota; a sink writes
through the gateway (``gateway=True``) on the block path, striped and
coalesced, with codec none and int8-block. The port's sink into the
reference's pool, the reference's sink into the port's pool and port into
port must each leave what reference into reference leaves, byte for byte:
each backend's SAVIME contents and DDL, the bytes each backend took in,
the tenant's usage, and a RouterSession's gather of the whole TAR. A
tenant over its quota gets the client package's typed QuotaExceededError
before any backend sees a byte, in every crossing. Plain parity of the
hash ring and the tenant registry. No assertion on the wall clock.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import repro.analysis as ranalysis  # noqa: E402
import repro.gateway as rgateway  # noqa: E402
import repro.transport as rtransport  # noqa: E402
import repro_torch.analysis as panalysis  # noqa: E402
import repro_torch.gateway as pgateway  # noqa: E402
import repro_torch.transport as ptransport  # noqa: E402
from _torch_crossings import (CROSSING_IDS, CROSSINGS, STRIPE, fields,  # noqa: E402
                              recording_ddl, savime_contents, stage_steps)

GATEWAY = {"ref": rgateway, "port": pgateway}
ANALYSIS = {"ref": ranalysis, "port": panalysis}
TRANSPORT = {"ref": rtransport, "port": ptransport}
PATHS = {"block": {}, "stripes2": dict(n_channels=2, stripe_bytes=STRIPE),
         "coalesce": dict(coalesce_bytes=STRIPE)}
QUOTA = 16 << 20


def _pool(pkg: str, quota: int = QUOTA):
    gw = GATEWAY[pkg]
    return gw.StagingPool(2, mem_capacity=64 << 20, tenants=[
        gw.Tenant("alice", token="tok-a", quota_bytes=quota),
        gw.Tenant("bob", token="tok-b", quota_bytes=64 << 10)]).start()


def _run(sink_pkg: str, server_pkg: str, path: str, codec: str) -> dict:
    pool = _pool(server_pkg)
    try:
        ddl = [recording_ddl(sv) for sv in pool.savimes]
        got = stage_steps(sink_pkg, pool.addr, gateway=True, tenant="tok-a",
                          codec=codec, **PATHS[path])
        with GATEWAY[sink_pkg].RouterSession(gateway_addr=pool.addr) as rs:
            gathered = rs.execute(ANALYSIS[sink_pkg].tar("sim_velocity")
                                  .attr("v").select()).array
        contents = [savime_contents(sv) for sv in pool.savimes]
        bytes_in = {k: v["bytes_in"] for k, v in pool.backend_stats().items()}
        usage = pool.gateway.tenants.snapshot()
    finally:
        pool.stop()
    return {"contents": contents, "ddl": ddl, "codec": got["codec"],
            "staged": got["staged"], "bytes_in": bytes_in, "usage": usage,
            "gathered": (gathered.dtype.str, gathered.shape,
                         gathered.tobytes())}


@functools.cache
def _reference(path: str, codec: str) -> dict:
    return _run("ref", "ref", path, codec)


@pytest.mark.parametrize("codec", ["none", "int8-block"])
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("sink,servers", CROSSINGS, ids=CROSSING_IDS)
def test_pool_leaves_the_reference_savime_contents(sink, servers, path,
                                                   codec):
    want = _reference(path, codec)
    got = _run(sink, servers, path, codec)
    assert got["ddl"] == want["ddl"]
    for b, (g, w) in enumerate(zip(got["contents"], want["contents"])):
        assert g.keys() == w.keys(), b
        for name in w:
            assert g[name] == w[name], (b, name)
    for k in ("codec", "staged", "bytes_in", "usage", "gathered"):
        assert got[k] == want[k], k
    # the data spread over both backends, and the gather holds every step
    assert all(v > 0 for v in want["bytes_in"].values())
    assert want["usage"]["alice"]["datasets"] == want["staged"][1]
    dtype, shape, raw = want["gathered"]
    assert shape == (2, 31, 64, 64)
    if codec == "none":
        assert raw == b"".join(f.tobytes() for f in fields())


def _quota_run(sink: str, servers: str, path: str) -> dict:
    """bob (64 KiB quota) writes the field, then alice writes it beside."""
    x = fields()[0]
    data = torch.from_numpy(x) if sink == "port" else x
    tp = TRANSPORT[sink]
    pool = _pool(servers)
    try:
        base = tp.TransportConfig(gateway_addr=pool.addr, tenant="tok-b",
                                  **PATHS[path])
        with tp.TransferSession("rdma_staged", base) as bob:
            fut = bob.write("bob_field", data)
            with pytest.raises(GATEWAY[sink].QuotaExceededError) as ei:
                fut.wait(30)
            bytes_in = {k: v["bytes_in"]
                        for k, v in pool.backend_stats().items()}
        with tp.TransferSession("rdma_staged",
                                base.replace(tenant="tok-a")) as alice:
            alice.write("alice_field", data).wait(30)
        usage = pool.gateway.tenants.snapshot()
        landed = [sv.engine.datasets.get("alice_field") for sv in pool.savimes]
    finally:
        pool.stop()
    return {"error": str(ei.value), "bytes_in_at_reject": bytes_in,
            "usage": usage,
            "landed": [None if d is None else d.tobytes() for d in landed]}


@functools.cache
def _quota_reference(path: str) -> dict:
    return _quota_run("ref", "ref", path)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("sink,servers", CROSSINGS, ids=CROSSING_IDS)
def test_quota_rejection_is_typed_in_every_crossing(sink, servers, path):
    """bob's 64 KiB quota: the field (507,904 B) is refused with the client
    package's QuotaExceededError (raised inside ``_quota_run``), and no
    backend takes in a byte; alice's write beside it lands. The rejection
    and the accounting are the reference's."""
    want = _quota_reference(path)
    got = _quota_run(sink, servers, path)
    assert got == want
    assert "tenant 'bob' byte quota exceeded" in want["error"]
    assert want["bytes_in_at_reject"] == {"backend0": 0, "backend1": 0}
    assert want["usage"]["bob"]["rejects"] >= 1
    assert want["usage"]["bob"]["bytes"] == 0
    assert want["usage"]["alice"]["bytes"] == fields()[0].nbytes
    held = [d for d in want["landed"] if d is not None]
    assert held == [fields()[0].tobytes()]


@pytest.mark.parametrize("n,weights,vnodes", [
    (2, None, 64), (3, None, 64), (3, (1.0, 2.0, 0.5), 16), (5, None, 8)])
def test_hash_ring_places_as_the_reference(n, weights, vnodes):
    def ring(gw):
        return gw.HashRing([gw.RingNode(
            name=f"backend{i}", addr=f"127.0.0.1:{7000 + i}",
            savime_addr=f"127.0.0.1:{8000 + i}",
            weight=weights[i] if weights else 1.0) for i in range(n)],
            vnodes=vnodes)
    ours, theirs = ring(pgateway), ring(rgateway)
    keys = [f"sim_velocity__{i}" for i in range(300)] + ["", "x", "ü/ß"]
    assert [ours.place(k).name for k in keys] == \
        [theirs.place(k).name for k in keys]
    assert ours.epoch == theirs.epoch
    assert ours.encode() == theirs.encode()
    assert pgateway.HashRing.decode(theirs.encode()).epoch == theirs.epoch
    assert ours.without_node("backend1").epoch == \
        theirs.without_node("backend1").epoch


def _charges(gw) -> list:
    reg = gw.TenantRegistry([gw.Tenant("t", token="tok", quota_bytes=100,
                                       quota_datasets=3),
                             gw.Tenant("u", quota_bytes=None)],
                            default_quota_bytes=50)
    out = []
    for who, nbytes, n in (("t", 60, 1), ("t", 60, 1), ("t", 30, 2),
                           ("t", 10, 1), ("t", 1, 1), ("default", 50, 1),
                           ("default", 1, 1), ("u", 10 ** 9, 7),
                           ("nobody", 1, 1)):
        try:
            reg.charge(who, nbytes, datasets=n)
            out.append(("ok", reg.usage(who)))
        except (gw.QuotaExceededError, gw.AuthError) as e:
            out.append((type(e).__name__, str(e)))
    for token in ("tok", "t", "u", "nope", None):
        try:
            out.append(("auth", reg.authenticate(token).name))
        except gw.AuthError as e:
            out.append(("AuthError", str(e)))
    out.append(("snapshot", reg.snapshot()))
    return out


def test_tenant_registry_charges_as_the_reference():
    assert _charges(pgateway) == _charges(rgateway)


@pytest.mark.parametrize("src,dst", [("port", "ref"), ("ref", "port")])
def test_typed_errors_cross_the_wire(src, dst):
    for exc in (GATEWAY[src].QuotaExceededError("over", tenant="t"),
                GATEWAY[src].AuthError("who")):
        reply = GATEWAY[src].error_reply(exc)
        back = GATEWAY[dst].error_from_reply(reply, "ctx")
        assert type(back).__name__ == type(exc).__name__
        assert isinstance(back, (GATEWAY[dst].QuotaExceededError,
                                 GATEWAY[dst].AuthError))
        assert str(exc) in str(back)
