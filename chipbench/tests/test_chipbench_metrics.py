"""The metrics' arithmetic: percentiles and spreads, and each reader on
records and traces whose answers are known."""
import random
import statistics

import numpy as np
import pytest

from chipbench import harness, stats, tracing
from chipbench.cost import flash_attention, model, ssm_scan
from chipbench.tests import smoke


def _read(name, **ctx):
    base = dict(config=smoke.config("qwen2-72b"), workload={}, records={},
                setup_s=0.0, trace=None)
    base.update(ctx)
    return harness.reader(smoke.ROOT, name).read(harness.Context(**base))


@pytest.mark.parametrize("n", [1, 2, 5, 20, 101])
def test_percentile_is_numpys_linear(n):
    xs = [random.Random(n).random() for _ in range(n)]
    for q in (0, 5, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == (q3 - q1) / q2
    assert stats.merge_intervals([(3, 4), (0, 2), (1, 3), (6, 7)]) == [(0, 4), (6, 7)]


def _prefill_records():
    calls = [{"L": 100, "B": 2, "ts": 0.0, "te": 1.0, "in_window": True},
             {"L": 200, "B": 2, "ts": 1.0, "te": 3.0, "in_window": True},
             {"L": 400, "B": 2, "ts": 3.0, "te": 7.0, "in_window": False}]
    return {"kind": "prefill", "t0": 0.0, "seconds": 5.0, "calls": calls}


def test_prefill_rate_leaves_out_the_cut_request():
    # 600 tokens by t = 3 s; the request cut at 5 s neither counts nor is charged
    assert _read("prefill_tokens_per_s", records=_prefill_records()) == 200.0
    assert _read("decode_tokens_per_s", records=_prefill_records()) is None


def _decode_records():
    te = [1.0 + 0.01 * i + (0.05 if i == 7 else 0.0) for i in range(20)]
    steps = [{"ts": t - 0.009 - (0.04 if i == 7 else 0.0), "tq": t - 0.004, "te": t,
              "past": 300.5 + i, "refill": 32 if i == 7 else 0,
              "tokens": 256 + (32 if i == 7 else 0), "in_window": i < 19}
             for i, t in enumerate(te)]
    return {"kind": "decode", "t0": 0.99, "seconds": 0.2, "B": 256,
            "prev_te": 0.99, "steps": steps}


def test_decode_rate_tail_and_enqueue():
    r = _decode_records()
    # 19 steps' tokens and one refill's, by the last of them at 1.18 s
    assert _read("decode_tokens_per_s", records=r) == pytest.approx(
        (256 * 19 + 32) / 0.19)
    gaps = np.diff([0.99] + [s["te"] for s in r["steps"][:19]]) * 1e3
    assert _read("itl_ms_p95", records=r) == pytest.approx(np.percentile(gaps, 95))
    # the refill's step is not an enqueue of one decode step
    assert _read("host_enqueue_ms.decode", records=r) == pytest.approx(5.0)
    assert _read("setup_s", setup_s=12.5) == 12.5
    cfg = smoke.config("qwen2-72b")
    wl = {"prompt_len": 8}
    least = (sum(model.least_seconds(cfg, 256, 1, s["past"], 256) for s in r["steps"])
             + model.least_seconds(cfg, 32, 8, 0, 32))
    trace = {"busy_s": 1.0, "window_s": 2.0, "kernels": {}, "idle_by_host": {}}
    assert _read("mfu_pct.decode", config=cfg, workload=wl, records=r,
                 trace=trace) == pytest.approx(100 * least / 2.0)
    # a mean position counts a step's work as its rows' positions do
    for key in ("flops", "bytes"):
        assert (model.step(cfg, 4, 1, 200.0, 4)[key] + model.step(cfg, 0, 1, 0, 0)[key]
                == pytest.approx(model.step(cfg, 2, 1, 100, 2)[key]
                                 + model.step(cfg, 2, 1, 300, 2)[key]))


def test_trace_readers():
    cfg = smoke.config("qwen2-72b")
    cfg["num_hidden_layers"] = 3
    r = _prefill_records()
    least_flash = 3 * sum(flash_attention.least_seconds(2, c["L"], c["L"], 4, 2, 16)
                          for c in r["calls"])
    trace = {"busy_s": 6.0, "window_s": 8.0,
             "kernels": {"void flash_fwd_wgmma<128, false>(...)": least_flash * 4,
                         "sm90_xmma_gemm": 1.0},
             "idle_by_host": {}}
    kw = dict(config=cfg, records=r, trace=trace)
    assert _read("flash_roofline_pct.prefill", **kw) == pytest.approx(25.0)
    assert _read("scan_roofline_pct.prefill", **kw) is None     # no scan here
    assert _read("device_idle_pct.prefill", **kw) == pytest.approx(25.0)
    assert _read("device_idle_pct.decode", **kw) is None
    least = sum(model.least_seconds(cfg, 2, c["L"], 0, 2) for c in r["calls"])
    assert _read("mfu_pct.prefill", **kw) == pytest.approx(100 * least / 8.0)
    assert _read("mfu_pct.prefill", config=cfg, records=r) is None  # untraced


def test_scan_roofline_reader():
    cfg = smoke.config("falcon-mamba-7b")
    r = _prefill_records()
    least = 2 * sum(ssm_scan.least_seconds(2, c["L"], 128, 8) for c in r["calls"])
    trace = {"busy_s": 1.0, "window_s": 1.0, "kernels": {"ssm_scan_kernel(Params)": least * 2},
             "idle_by_host": {}}
    assert _read("scan_roofline_pct.prefill", config=cfg, records=r,
                 trace=trace) == pytest.approx(50.0)


def test_idle_gaps_go_to_the_innermost_host_span():
    cpu = [(0, 100_000, "chipbench.request"), (10_000, 20_000, "aten::mm"),
           (50_000, 90_000, "cudaStreamSynchronize")]
    gaps = [(12_000, 18_000), (60_000, 70_000), (93_000, 99_000), (30_000, 31_000)]
    out = tracing._attribute(gaps, cpu)
    assert out == pytest.approx({"aten::mm": 6e-6, "cudaStreamSynchronize": 1e-5,
                                 "chipbench.request": 6e-6, "gaps under 5 us": 1e-6})
    bd = tracing.breakdown({"kernels": {f"k{i}": float(i) for i in range(15)},
                            "idle_by_host": out})
    assert len(bd["device_ops"]) == 10 and bd["device_ops"][0] == ["k14", 14.0]
