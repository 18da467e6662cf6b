"""Shared pieces of the port's data-plane crossing tests: the same values
staged by one package's sink into the other package's servers (port into
reference, reference into port, port into port) must leave what the
reference's sink leaves in the reference's servers.

The values: ``N_STEPS`` steps of the reference's SeismicField at the
example's mesh (31x64x64 float32, 507,904 bytes a step: 7.75 stripes of
64 KiB, so the last stripe is ragged) and a small tree of diagnostics
(float32, int64) a step. The port's sink is given torch tensors on the
CPU, the reference's sink numpy arrays.
"""
import dataclasses
import functools

import numpy as np
import torch

import repro.core as rcore
import repro_torch.core as pcore
from repro.data.seismic import SeismicConfig, SeismicField

CORE = {"ref": rcore, "port": pcore}
MESH = dict(nx=31, ny=64, nz=64)
N_STEPS = 2
STRIPE = 64 << 10
CROSSINGS = [("port", "ref"), ("ref", "port"), ("port", "port")]
CROSSING_IDS = ["port_sink-ref_servers", "ref_sink-port_servers",
                "port_sink-port_servers"]


@functools.cache
def fields(n_steps: int = N_STEPS) -> tuple:
    f = SeismicField(SeismicConfig(**MESH))
    return tuple(f.step(t).astype(np.float32) for t in range(n_steps))


def tree(step: int, as_tensor: bool) -> dict:
    r = np.random.default_rng(step)
    leaves = {"loss": r.standard_normal(1).astype(np.float32),
              "grad/norm": r.standard_normal((3, 5)).astype(np.float32),
              "tok.count": np.arange(4, dtype=np.int64) + step}
    if as_tensor:
        leaves = {k: torch.from_numpy(v) for k, v in leaves.items()}
    return {"diag": leaves, "lr": leaves["loss"] * 0}


def savime_contents(sv) -> dict:
    """Every TAR with its dimensions, attributes and subtars' bytes, and
    the datasets SAVIME holds but has not loaded."""
    eng = sv.engine
    out = {}
    for name, t in sorted(eng.tars.items()):
        subs = sorted((st.origin, st.shape, tuple(
            (a, v.dtype.str, v.tobytes()) for a, v in sorted(st.data.items())))
            for st in t.subtars)
        out[name] = ([dataclasses.astuple(d) for d in t.dims],
                     sorted(dataclasses.astuple(a) for a in t.attrs.values()),
                     subs)
    out["__datasets__"] = sorted(eng.datasets)
    return out


def recording_ddl(sv) -> list:
    """Record every statement SAVIME runs from now on."""
    ddl = []
    run = sv.engine.run

    def recording_run(q):
        ddl.append(q)
        return run(q)

    sv.engine.run = recording_run
    return ddl


def stage_steps(sink_pkg: str, addr: str, n_steps: int = N_STEPS,
                **cfg) -> dict:
    """Stage the fields and trees through ``sink_pkg``'s InTransitSink at
    ``addr`` with ``cfg``; returns the sender's codec stats (without the
    encode time), staged bytes and arrays, and its channels' stats."""
    sinks = CORE[sink_pkg]
    sink = sinks.InTransitSink(addr, sinks.InTransitConfig(
        tar_prefix="sim", **cfg))
    try:
        port = sink_pkg == "port"
        for step, field in enumerate(fields(n_steps)):
            sink.stage_array("velocity",
                             torch.from_numpy(field) if port else field,
                             step=step)
            sink.stage_tree("t_", tree(step, port), step=step)
        sink.flush(timeout=60)
        staged = (sink.staged_bytes, sink.staged_arrays)
    finally:
        sink.close()
    codec = dict(sink.session.stats.codec)
    codec.pop("encode_s", None)
    return {"codec": codec, "staged": staged,
            "channels": sink.session.stats.channels,
            "replays": sink.session.stats.replays}
