"""The weight GEMMs' share of their roofline in the traced prefill window:
the least time of the products with weight matrices the traced calls need
(``chipbench.cost.gemm``: every token through every layer's matrices, the
head on each row's last token; the matrices read once) over the device
time of the operations launched inside the program's ``repro_torch.gemm``
spans."""
from chipbench.cost import gemm

SPAN = "repro_torch.gemm"


def read(ctx):
    t, r = ctx.trace, ctx.records
    if t is None or r["kind"] != "prefill" or not r["calls"]:
        return None
    busy = t.get("device_by_span", {}).get(SPAN, 0.0)
    if busy <= 0:
        return None
    least = sum(gemm.least_seconds(ctx.config, c["B"], c["L"], c["B"]) for c in r["calls"])
    return 100.0 * least / busy
