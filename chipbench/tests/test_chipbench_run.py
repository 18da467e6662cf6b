"""A whole run of each cell at smoke size on the CPU (the harness's look
for a card skipped): the result line's schema, untraced and traced; and
the timed path broken underneath, once for each fault a serving cell can
have, so that ``correct`` comes out false."""
import json

import pytest
import torch

from chipbench import harness, run
from chipbench.tests import smoke

CPU = torch.device("cpu")
BENCH = json.loads((smoke.ROOT / "BENCHMARK.json").read_text())


def _run(cell, trace=False, seed=2**31 + 5):
    w = smoke.workload(cell)
    return harness.run_cell(cell, seed, smoke.WINDOW[w["loop"]], trace, CPU, 0.0,
                            config=smoke.config_of(cell), workload=w,
                            clock=smoke.StepClock())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", smoke.CELLS)
def test_the_result_line(cell, trace):
    out, lines = _run(cell, trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"]: m["unit"] for m in harness.metrics_of(BENCH, cell, trace)}
    assert set(out["metrics"]) <= set(want)
    for name, m in out["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    if not trace:
        assert set(out["metrics"]) == set(want)      # every end-to-end metric
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
        bd = out["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in bd.values())
    limits = harness.workload_file(smoke.ROOT, cell)["check"]["limits"]
    assert set(out["checks"]) == set(limits)
    assert len(lines) == len(limits) and all("limit" in x for x in lines)
    json.dumps(out)


def _roll(fn):
    def broken(self, *a, **kw):
        logits, cache = fn(self, *a, **kw)
        return logits.roll(1, -1), cache
    return broken


def _no_insert(cache, k_new, v_new, pos, seq=None):
    return cache


FAULTS = [
    ("qwen2-72b.long-prefill", "token altered", "Model.prefill"),
    ("qwen2-72b.batch-decode", "token altered", "Model.prefill"),
    ("qwen2-72b.batch-decode", "token altered", "Model.decode_step"),
    ("qwen2-72b.batch-decode", "state unchanged", "kvcache.cache_insert"),
]


@pytest.mark.parametrize("cell,fault,where", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault, where, monkeypatch):
    from repro_torch.models import kvcache
    from repro_torch.models.model import Model

    if where.startswith("Model."):
        name = where.split(".")[1]
        monkeypatch.setattr(Model, name, _roll(getattr(Model, name)))
    else:
        monkeypatch.setattr(kvcache, "cache_insert", _no_insert)
    out, _ = _run(cell)
    assert out["correct"] is False, (fault, out["checks"])


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: the refusal is for machines without one")
    assert run.main(["--workload", "qwen2-72b.long-prefill", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
