"""tools/decode_steps.py reads a batch-decode window's own records: run on
the CPU at the benchmark tests' smoke sizes, on a clock that moves 1 ms a
read, so the window holds the same steps on any machine."""
import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CELL = "qwen2-72b.batch-decode"


def _tool():
    spec = importlib.util.spec_from_file_location("decode_steps", ROOT / "tools" / "decode_steps.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decode_steps_reads_a_smoke_window(monkeypatch):
    torch = pytest.importorskip("torch")
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    monkeypatch.syspath_prepend(str(ROOT))
    from chipbench import harness
    from chipbench.tests import smoke
    tool = _tool()
    assert tool.CELL == CELL
    cl = harness.prepare(CELL, 2**31 + 7, torch.device("cpu"), ROOT,
                         config=smoke.config_of(CELL), workload=smoke.workload(CELL),
                         clock=smoke.StepClock())
    records, _ = harness.window(cl, smoke.WINDOW["decode"], False)
    ctx = harness.Context(cl.run.config, cl.run.workload, records, 1.0, None)
    metrics = {"decode_tokens_per_s": harness.reader(ROOT, "decode_tokens_per_s").read(ctx)}
    got = tool.read_window(records, metrics, cpu_s=0.5, wall_s=1.0)
    steps = [s for s in records["steps"] if s["in_window"]]
    assert got["steps"] == len(steps) > 10
    assert len(got["refill_gaps_ms"]) == sum(1 for s in steps if s["refill"]) >= 1
    lo, mid, hi = got["gap_ms_quartiles"]
    assert 0 < lo <= mid <= hi
    assert got["enqueue_ms_quartiles"][0] > 0
    assert len(got["gap_ms_median_by_tenth"]) == 10
    assert 0 <= got["steps_over_1.2x_median"] < got["steps"]
    assert got["cpu_over_wall"] == 0.5
    assert got["decode_tokens_per_s"] == metrics["decode_tokens_per_s"] > 0
    assert "decode_steps" not in sys.modules
