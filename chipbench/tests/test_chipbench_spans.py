"""The program's spans as the benchmark reads them: their nesting and
count in a step at smoke size, the attribution of device operations and
idle gaps to them (``chipbench.spans``) on fabricated tuples, the weight
GEMMs' yardstick (``chipbench.cost.gemm``) and the readers of the three
roofline shares that read the spans; and, on the card only, the
attribution of a real decode step."""
import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chipbench import harness, port, spans, tracing, weights
from chipbench.cost import flash_attention, gemm, peaks
from chipbench.tests import smoke

PARENT = {"repro_torch.block": "repro_torch.{step}", "repro_torch.attn": "repro_torch.block",
          "repro_torch.mlp": "repro_torch.block", "repro_torch.rope": "repro_torch.attn",
          "repro_torch.kv": "repro_torch.attn", "repro_torch.attn.decode": "repro_torch.attn",
          "repro_torch.attn.flash": "repro_torch.attn"}


def _model(device, seed=11):
    from repro_torch.models import Model
    from repro_torch.train.serve_step import ServeSetup

    c = smoke.config("qwen2-72b")
    model = Model(port.arch_config(c))
    params = port.params(model, c, weights.make(c, seed, device))
    return c, ServeSetup(model), params


def _tokens(device):
    return torch.arange(16, device=device).reshape(2, 8) % 251


def _step(kind, serve, params, device):
    """One prefill of 2 x 8 tokens, or one decode step after it."""
    toks = _tokens(device)
    logits, cache = serve.prefill_fn(max_len=16)(params, {"tokens": toks})
    if kind == "prefill":
        return lambda: serve.prefill_fn(max_len=16)(params, {"tokens": toks})
    pos = torch.full((2,), 8, dtype=torch.int32, device=device)
    return lambda: serve.decode_fn()(params, cache, {"tokens": toks[:, :1], "pos": pos})


def _parents(evs):
    """Each program span's (name, parent name) on the host's stack."""
    out, stack = [], []
    for s, e, n in sorted(evs, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((n, stack[-1][2] if stack else None))
        stack.append((s, e, n))
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_step_records_the_spans_nested_and_counted(kind):
    c, serve, params = _model(torch.device("cpu"))
    step = _step(kind, serve, params, torch.device("cpu"))
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    evs = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events() if e.name().startswith(spans.PROGRAM)]
    L = c["num_hidden_layers"]
    assert len(evs) == 16 * L + 3
    inner = "repro_torch.attn.decode" if kind == "decode" else "repro_torch.attn.flash"
    assert collections.Counter(n for _, _, n in evs) == {
        f"repro_torch.{kind}": 1, "repro_torch.block": L, "repro_torch.attn": L,
        "repro_torch.mlp": L, "repro_torch.kv": L, inner: L, "repro_torch.rope": 2 * L,
        "repro_torch.norm": 2 * L + 1, "repro_torch.gemm": 7 * L + 1}
    pairs = _parents(evs)
    assert pairs[0] == (f"repro_torch.{kind}", None)
    for name, parent in pairs[1:]:
        if name in PARENT:
            assert parent == PARENT[name].format(step=kind), (name, parent)
    gemm_parents = collections.Counter(p for n, p in pairs if n == "repro_torch.gemm")
    assert gemm_parents == {"repro_torch.attn": 4 * L, "repro_torch.mlp": 3 * L,
                            f"repro_torch.{kind}": 1}
    norm_parents = collections.Counter(p for n, p in pairs if n == "repro_torch.norm")
    assert norm_parents == {"repro_torch.block": 2 * L, f"repro_torch.{kind}": 1}


# (start, end, name, thread) spans of two threads; the launches' thread 7
SPANS = [(0, 100, "repro_torch.decode", 7), (10, 60, "repro_torch.attn", 7),
         (20, 30, "repro_torch.gemm", 7), (30, 40, "repro_torch.kv", 7),
         (5, 95, "repro_torch.prefill", 8)]


def test_an_op_goes_under_the_innermost_span_of_its_launch():
    launches = {1: (25, 7), 2: (30, 7), 3: (45, 7), 4: (80, 7), 5: (150, 7), 6: (50, 9)}
    ops = [(1000, 1004, 1), (1004, 1006, 2), (1010, 1020, 3), (1020, 1021, 4),
           (1030, 1040, 5), (1040, 1042, 6), (1050, 1053, 99)]
    out = spans.device_by_span(ops, launches, SPANS)
    assert out == pytest.approx({
        "repro_torch.gemm": 4e-9,          # launched at 25, inside gemm inside attn
        "repro_torch.kv": 2e-9,            # at 30 gemm ends and kv opens: kv's
        "repro_torch.attn": 10e-9,         # at 45, in attn alone
        "repro_torch.decode": 1e-9,        # at 80, in the step alone
        spans.OUTSIDE: 10e-9 + 2e-9,       # after the step; a thread with no span
        spans.UNLINKED: 3e-9})             # no launch of correlation 99
    total = sum(e - s for s, e, _ in ops) * 1e-9
    assert sum(out.values()) == pytest.approx(total)


def test_idle_gaps_and_host_time_go_to_the_spans():
    gaps = [(22, 28), (41, 49), (96, 98), (150, 160)]
    out = spans.idle_by_span(gaps, SPANS[:4])
    assert out == pytest.approx({"repro_torch.gemm": 6e-9, "repro_torch.attn": 8e-9,
                                 "repro_torch.decode": 2e-9, spans.OUTSIDE: 10e-9})
    own = spans.host_by_span(SPANS)
    assert own == pytest.approx({"repro_torch.decode": 50e-9, "repro_torch.attn": 30e-9,
                                 "repro_torch.gemm": 10e-9, "repro_torch.kv": 10e-9,
                                 "repro_torch.prefill": 90e-9})


def test_gemm_yardstick_of_the_qwen2_stage():
    c = json.loads((smoke.ROOT / "chipbench/configs/qwen2-72b.json").read_text())
    assert gemm.layer_matrix_params(c, "dense") == 877_658_112
    P, head = 10 * 877_658_112, 8192 * 152064
    x = gemm.cost(c, 1, 32768, 1)
    assert x == {"flops": 2.0 * 32768 * P + 2.0 * head, "bytes": 2.0 * (P + head)}
    # a prefill cycle is bound by its operations, a decode step by its bytes
    cycle = sum(gemm.least_seconds(c, 1, L, 1) for L in (8192, 16384, 32768))
    assert cycle == pytest.approx(2.0 * 57344 * P / peaks.BF16_FLOPS + 6 * head / peaks.BF16_FLOPS)
    assert 1.017 < cycle < 1.019
    assert gemm.least_seconds(c, 256, 1, 256) == 2.0 * (P + head) / peaks.HBM_BYTES


def _read(name, **ctx):
    base = dict(config=smoke.config("qwen2-72b"), workload={}, records={},
                setup_s=0.0, trace=None)
    base.update(ctx)
    return harness.reader(smoke.ROOT, name).read(harness.Context(**base))


def test_the_span_readers():
    cfg = smoke.config("qwen2-72b")
    cfg["num_hidden_layers"] = 3
    steps = [{"past": 300.5 + i, "refill": 4 if i == 2 else 0} for i in range(5)]
    dec = {"kind": "decode", "B": 8, "steps": steps}
    pre = {"kind": "prefill", "calls": [{"L": 100, "B": 2}, {"L": 200, "B": 2}]}
    attn = 3 * sum(flash_attention.least_seconds(8, 1, s["past"] + 1, 4, 2, 16) for s in steps)
    g_dec = (5 * gemm.least_seconds(cfg, 8, 1, 8) + gemm.least_seconds(cfg, 4, 8, 4))
    g_pre = gemm.least_seconds(cfg, 2, 100, 2) + gemm.least_seconds(cfg, 2, 200, 2)
    trace = {"busy_s": 1.0, "window_s": 2.0, "kernels": {}, "idle_by_host": {},
             "device_by_span": {"repro_torch.attn.decode": attn * 10,
                                "repro_torch.gemm": g_dec * 2}}
    kw = dict(config=cfg, workload={"prompt_len": 8}, trace=trace)
    assert _read("decode_attn_roofline_pct.decode", records=dec, **kw) == pytest.approx(10.0)
    assert _read("gemm_roofline_pct.decode", records=dec, **kw) == pytest.approx(50.0)
    assert _read("gemm_roofline_pct.prefill", records=dec, **kw) is None
    trace["device_by_span"] = {"repro_torch.gemm": g_pre * 4}
    assert _read("gemm_roofline_pct.prefill", records=pre, **kw) == pytest.approx(25.0)
    # no span time (the CPU, or a program without spans), or untraced: nothing
    assert _read("decode_attn_roofline_pct.decode", records=dec, **kw) is None
    trace.pop("device_by_span")
    for name, r in (("gemm_roofline_pct.prefill", pre), ("gemm_roofline_pct.decode", dec)):
        assert _read(name, records=r, **kw) is None
        assert _read(name, records=r, config=cfg, workload={"prompt_len": 8}) is None


@pytest.mark.cuda
def test_on_the_card_a_decode_steps_ops_land_under_its_spans():
    """Every device op launched inside ``repro_torch.decode`` lands under a
    program span deeper than it, but the embedding's lookup, which no span
    covers; ``unlinked`` is under 1% of the ops' time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ops are linked to their launches there")
    from repro_torch.models.layers import embed

    dev = torch.device("cuda", 0)
    with torch.inference_mode():
        c, serve, params = _model(dev)
        step = _step("decode", serve, params, dev)
        toks = _tokens(dev)[:, :1]          # the decode step's own tokens
        step()
        torch.cuda.synchronize()

        def attributed(fn):
            tr = tracing.Trace(True, dev)
            with tr:
                fn()
                torch.cuda.synchronize()
            _, ops, launches, sp = spans.events(tr.prof)
            linked = [(n, launches[k]) for _, _, n, k in ops if k in launches]
            names = spans.innermost(sp, [call for _, call in linked])
            return (ops, launches, [(n, s) for (n, _), s in zip(linked, names)],
                    tr.summary()["kernels"])

        ops, launches, named, kernels = attributed(step)
        _, _, lookup, _ = attributed(lambda: embed(params["embed"], toks, False,
                                                   torch.bfloat16))
    total = sum(e - s for s, e, _, _ in ops)
    lost = sum(e - s for s, e, _, k in ops if k not in launches)
    assert total > 0 and lost < 0.01 * total
    own = sorted(n for n, s in named if s == "repro_torch.decode")
    assert own == sorted(n for n, _ in lookup), (own, lookup)
    assert {s for _, s in named} >= {"repro_torch.gemm", "repro_torch.attn.decode",
                                     "repro_torch.kv", "repro_torch.rope",
                                     "repro_torch.norm"}
    assert kernels and not [n for n in kernels if n.startswith(spans.PROGRAM)]
