"""A bfloat16 tensor through the port's sink, staging and SAVIME in a Python
process that has no jax, jaxlib, ml_dtypes or repro (so numpy has no
bfloat16 dtype), for codec none / int8-block x quantize none / int8, on
each transport asked for (the staged path by default; a copy baseline
reaches SAVIME directly).

``run(device, transports)`` starts that process and returns one reading
per case. The
values are 8197 of ``linspace(-2, 2)`` in bfloat16. SAVIME must hold their
bits (uint16, 2 bytes a value) under attribute type "bfloat16", and a query
must give them back widened to float32. Where the tensor lies on the card
and the codec is int8-block on the staged path, the codec quantizes it
there (the staging_pack kernel) and SAVIME holds the decode of that, which
must equal the same codec's encode and decode of the tensor on the CPU (the
kernel's plain version); otherwise it holds the values' own bits.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

BLOCKED = ("jax", "jaxlib", "ml_dtypes", "repro")
N = 8197

_PROG = r'''
import json, sys
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import torch
from repro_torch.analysis import AnalysisSession, tar
from repro_torch.codec.int8block import Int8BlockCodec
from repro_torch.core import (InTransitConfig, InTransitSink, SavimeServer,
                              StagingServer)
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.tensors import bf16_to_f32, to_host

dev = sys.argv[1]
transports = sys.argv[2].split(",")
x = torch.linspace(-2, 2, N, dtype=torch.bfloat16, device=dev)
bits = to_host(x)
codec_cpu = Int8BlockCodec()
decoded = codec_cpu.decode(*codec_cpu.encode(x.cpu())).view(np.uint16)
out = []
for transport in transports:
  staged = transport == "rdma_staged"
  for codec in ("none", "int8-block"):
    for quantize in ("none", "int8"):
        sv = SavimeServer().start()
        st = StagingServer(sv.addr, mem_capacity=16 << 20).start()
        try:
            sink = InTransitSink(st.addr if staged else sv.addr,
                                 InTransitConfig(tar_prefix="s", codec=codec,
                                                 quantize=quantize,
                                                 transport=transport))
            try:
                reset_launches()
                sink.stage_array("a", x, step=0)
                sink.flush(timeout=60)
                launches = LAUNCHES["staging_pack"]
            finally:
                sink.close()
            t = sv.engine.tars["s_a"]
            held = t.select("v")
            with AnalysisSession(sv.addr) as an:
                got = an.execute(tar("s_a").attr("v").select()).array
            packed = (dev != "cpu" and staged and codec == "int8-block"
                      and quantize == "none")
            want = decoded if packed else bits
            out.append(dict(
                transport=transport, codec=codec, quantize=quantize,
                packed=packed,
                launches=launches, tars=sorted(sv.engine.tars),
                attr=[t.attrs["v"].dtype, [d.upper for d in t.dims]],
                held=[str(held.dtype), list(held.shape)],
                bits_equal=held.reshape(-1).tobytes() == want.tobytes(),
                query=[str(got.dtype), list(got.shape)],
                query_equal=bool(np.array_equal(got.reshape(-1),
                                                bf16_to_f32(want))),
                max_err=float(np.abs(bf16_to_f32(held.reshape(-1))
                                     - x.float().cpu().numpy()).max()),
                imported=sorted({m.split(".")[0] for m in sys.modules
                                 if sys.modules[m] is not None} & set(BLOCKED))))
        finally:
            st.stop()
            sv.stop()
print("RESULT " + json.dumps(out))
'''


def run(device: str, transports=("rdma_staged",),
        timeout: float = 300) -> list[dict]:
    root = Path(__file__).resolve().parent.parent
    prog = f"BLOCKED = {BLOCKED!r}\nN = {N}\n" + _PROG
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run([sys.executable, "-c", prog, device,
                        ",".join(transports)], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])
