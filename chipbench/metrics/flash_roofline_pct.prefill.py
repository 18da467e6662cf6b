"""The flash-attention kernel's share of its roofline in the traced
prefill window: the least time of the attention the traced calls need
(``chipbench.cost.flash_attention``, causal, each attention layer of each
call) over the device time of the kernels named ``flash_fwd`` in the
trace."""
from chipbench.cost import flash_attention
from chipbench.reference import dense
from chipbench.reference.model import layer_kinds

KERNEL = "flash_fwd"


def read(ctx):
    t, r = ctx.trace, ctx.records
    if t is None or r["kind"] != "prefill":
        return None
    busy = sum(s for n, s in t["kernels"].items() if KERNEL in n)
    layers = layer_kinds(ctx.config).count("dense")
    if busy <= 0 or not layers:
        return None
    d = dense.dims(ctx.config)
    least = layers * sum(flash_attention.least_seconds(
        c["B"], c["L"], c["L"], d["Hq"], d["Hkv"], d["D"]) for c in r["calls"])
    return 100.0 * least / busy
