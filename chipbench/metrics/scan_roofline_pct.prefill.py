"""The selective-scan kernel's share of its roofline in the traced
prefill window: the least time of the scans the traced calls need
(``chipbench.cost.ssm_scan``: bytes, float32 operations and exponentials
at the SFU's rate, each mamba layer of each call) over the device time of
the kernels named ``ssm_scan`` in the trace."""
from chipbench.cost import ssm_scan
from chipbench.reference import mamba
from chipbench.reference.model import layer_kinds

KERNEL = "ssm_scan"


def read(ctx):
    t, r = ctx.trace, ctx.records
    if t is None or r["kind"] != "prefill":
        return None
    busy = sum(s for n, s in t["kernels"].items() if KERNEL in n)
    layers = layer_kinds(ctx.config).count("mamba")
    if busy <= 0 or not layers:
        return None
    d = mamba.dims(ctx.config)
    least = layers * sum(ssm_scan.least_seconds(c["B"], c["L"], d["di"], d["N"])
                         for c in r["calls"])
    return 100.0 * least / busy
