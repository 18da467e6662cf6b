"""Decode attention's share of its roofline in the traced decode window:
the least time of the attention the traced steps need
(``chipbench.cost.flash_attention``: one query row a session against its
keys up to its position, each dense layer of each step, taken at the rows'
mean position, which both counts are linear in) over the device time of
the operations launched inside the program's ``repro_torch.attn.decode``
span."""
from chipbench.cost import flash_attention
from chipbench.reference import dense
from chipbench.reference.model import layer_kinds

SPAN = "repro_torch.attn.decode"


def read(ctx):
    t, r = ctx.trace, ctx.records
    if t is None or r["kind"] != "decode" or not r["steps"]:
        return None
    busy = t.get("device_by_span", {}).get(SPAN, 0.0)
    layers = layer_kinds(ctx.config).count("dense")
    if busy <= 0 or not layers:
        return None
    d = dense.dims(ctx.config)
    least = layers * sum(flash_attention.least_seconds(
        r["B"], 1, s["past"] + 1, d["Hq"], d["Hkv"], d["D"]) for s in r["steps"])
    return 100.0 * least / busy
