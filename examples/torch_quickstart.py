"""Quickstart on the PyTorch port: the paper's Listing 1 plus the typed
analysis API. The twin of ``examples/quickstart.py``.

Starts an in-memory SAVIME and a staging server, ships a 3-D velocity
field (a tensor on the device: CUDA unless ``--device cpu``) through the
RDMA-emulated staging path via a TransferSession, and reads it back through
an AnalysisSession: a live ``watch()`` subscription sees the subtar land
while the writer runs, then typed builder queries and a registered analyzer
summarize the field. Then the same pipeline against a 3-server staging
pool behind one gateway.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--smoke]

``--smoke`` shrinks the array for CI (loopback, ~1 MB).
"""
import argparse

import numpy as np
import torch

from repro_torch.analysis import (AnalysisSession, CreateTar, LoadSubtar,
                                  analyzers, tar)
from repro_torch.core import SavimeServer, StagingServer
from repro_torch.core.tars import Attribute, Dimension
from repro_torch.device import resolve_device
from repro_torch.transport import TransferSession, TransportConfig

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default) or cpu; cuda raises when absent")
ap.add_argument("--smoke", action="store_true", help="tiny arrays for CI")
args = ap.parse_args()
dev = resolve_device(args.device)
nx, ny = (41, 36) if args.smoke else (201, 126)

savime = SavimeServer().start()
staging = StagingServer(savime.addr, mem_capacity=1 << 30).start()

cfg = TransportConfig(staging_addr=staging.addr, io_threads=1,
                      block_size=4 << 20)
with TransferSession("rdma_staged", cfg) as st, \
        AnalysisSession(savime.addr) as an:
    # --- the paper's Listing 1, typed ----------------------------------
    an.execute(CreateTar("velocity",
                         (Dimension("x", 0, nx - 1),
                          Dimension("y", 0, ny - 1),
                          Dimension("z", 0, ny - 1)),
                         (Attribute("v", "float64"),)))
    with an.watch("velocity", timeout=15.0, max_events=1) as sub:
        host = np.random.default_rng(0).standard_normal((nx, ny, ny))
        v = torch.from_numpy(host).to(dev)   # the producer's field
        fut = st.write("D", v)           # asynchronous: returns a future
        st.sync()                        # writes reached staging
        st.drain()                       # staging -> SAVIME done
        assert fut.done()
        an.execute(LoadSubtar("velocity", "D", (0, 0, 0), (nx, ny, ny), "v"))
        events = list(sub)               # the subscription saw it arrive
        assert len(events) == 1 and events[0].tar == "velocity"
        print(f"watch: subtar {events[0].origin}+{events[0].shape} "
              f"arrived (seq {events[0].seq})")
    # --- typed queries (fluent builder -> compiled in one place) -------
    mean = an.execute(tar("velocity").attr("v").mean())
    corner = an.execute(
        tar("velocity").attr("v").range((0, 0, 0), (10, 10, 10)).max())
    print(f"mean(v) via SAVIME = {mean.value:.6f}   (torch: "
          f"{float(v.mean()):.6f} on {v.device})")
    print(f"max over [0:10]^3  = {corner.value:.6f} "
          f"(torch: {float(v[:11, :11, :11].max()):.6f})")
    assert np.isclose(mean.value, float(v.mean()))
    assert corner.value == float(v[:11, :11, :11].max())
    # --- a registered analyzer over a typed result ---------------------
    rs = analyzers.create("running_stats")
    back = an.execute(tar("velocity").attr("v").select())
    assert back.array.tobytes() == host.tobytes()   # the field, bit for bit
    rs.update(back)
    s = rs.summary()
    print(f"analyzer[{s.analyzer}]: mean={s['mean']:.4f} std={s['std']:.4f} "
          f"count={s['count']}")
    assert s["count"] == v.numel()
    print("server:", {k: x for k, x in st.server_stats().items()
                      if k in ("datasets", "bytes_in", "registrations")})

print(f"egress: {st.stats.nbytes / 1e6:.1f} MB in "
      f"{st.stats.to_staging_s:.3f}s to staging "
      f"({st.stats.staging_gbps:.2f} GB/s)")
print(f"analysis: {an.stats.n_queries} queries, "
      f"mean {an.stats.mean_query_s * 1e3:.2f} ms, kinds {an.stats.by_kind}")
staging.stop()
savime.stop()

# --- the same pipeline against a 3-server staging pool (DESIGN.md §12) ---
# One gateway address fronts N (staging, SAVIME) pairs: datasets place
# onto backends by consistent hash, and a RouterSession answers one
# query over the sharded tar exactly as a single server would.
from repro_torch.gateway import RouterSession, StagingPool  # noqa: E402

width = ny * ny
parts = {f"slab{i}": np.random.default_rng(i).standard_normal(width)
         for i in range(6)}
with StagingPool(3, mem_capacity=1 << 30) as pool:
    cfg = TransportConfig(gateway_addr=pool.addr)
    with TransferSession("rdma_staged", cfg) as st:
        st.run_savime(f'create_tar(field, "x:0:{6 * width - 1}", '
                      f'"v:float64")')
        for name, arr in parts.items():
            st.write(name, torch.from_numpy(arr).to(dev))
        st.sync()
        st.drain()
        for i, name in enumerate(parts):
            st.run_savime(f'load_subtar(field, {name}, "{width * i}", '
                          f'"{width}", v)')
        with RouterSession(gateway_addr=pool.addr) as router:
            total = router.execute(tar("field").attr("v").sum())
    expect = float(np.sum(np.concatenate(list(parts.values()))))
    assert total.value == expect, (total.value, expect)
    print(f"pool: {len(parts)} datasets sharded over 3 backends; "
          f"sum(v) = {total.value:.6f} (numpy: {expect:.6f})")
    gw = st.stats.gateway
    print(f"gateway: {gw['totals']} across {gw['live_backends']} backends")
print("OK")
