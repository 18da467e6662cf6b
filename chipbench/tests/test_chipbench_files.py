"""BENCHMARK.json is well formed, every file it names is
found by name, adding a cell, a configuration and a metric takes new files
alone, and nothing under chipbench/ imports the JAX stack, the JAX package
or the reference's benchmarks (the reference and the yardstick nothing of
the program either)."""
import ast
import json
import re
import shutil

import pytest
import torch

from chipbench import harness
from chipbench.tests import smoke

ROOT = smoke.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


def test_benchmark_json_is_well_formed():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["chipbench"] and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("chipbench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS and NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for text in ([c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    # every cell reports set-up, another end-to-end metric and a per-layer one
    for cell in cells:
        assert len(harness.metrics_of(BENCH, cell, False)) >= 2
        assert harness.metrics_of(BENCH, cell, True)
    # 24 cells at this length, 14 runs each, fit a 12-hour check
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCH["workloads"]))
def test_each_cell_finds_its_files_by_name(cell):
    entry = harness.cell_entry(BENCH, cell)
    c = harness.config_file(ROOT, BENCH, entry["config"])
    conf = next(x for x in BENCH["configs"] if x["name"] == entry["config"])
    assert c["source"] == conf["source"] and sorted(c["reduced"]) == sorted(conf["reduced"])
    for key in c["port"]["fields"].values():
        assert key in c
    w = harness.workload_file(ROOT, cell)
    assert (ROOT / "chipbench" / "loops" / f"{w['loop']}.py").exists()
    assert w["check"]["limits"] and w["check"]["sample"] >= 1
    for m in harness.metrics_of(BENCH, cell, False) + harness.metrics_of(BENCH, cell, True):
        assert callable(harness.reader(ROOT, m["name"]).read)


def _roots(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.partition(".")[0])
    return out


def test_nothing_imports_jax_the_jax_package_or_its_benchmarks():
    files = sorted((ROOT / "chipbench").rglob("*.py"))
    assert len(files) > 20
    bad = {str(f): sorted(_roots(f) & {"jax", "jaxlib", "flax", "repro", "benchmarks"})
           for f in files}
    assert not {f: r for f, r in bad.items() if r}
    for sub in ("reference", "cost"):
        for f in (ROOT / "chipbench" / sub).rglob("*.py"):
            assert "repro_torch" not in _roots(f), f


def test_a_cell_a_configuration_and_a_metric_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a
    per-layer metric by new files and new entries in BENCHMARK.json; the
    run finds and reports them with no existing file edited."""
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "chipbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    c = smoke.config("qwen2-72b")
    c["name"] = "qwen2-tiny"
    (tmp_path / "chipbench/configs/qwen2-tiny.json").write_text(json.dumps(c))
    w = smoke.workload("qwen2-72b.long-prefill")
    w["prompt_lengths"] = [8, 24]
    (tmp_path / "chipbench/workloads/qwen2-tiny.short-prefill.json").write_text(json.dumps(w))
    (tmp_path / "chipbench/metrics/calls_done.prefill.py").write_text(
        "def read(ctx):\n    return float(len(ctx.records['calls']))\n")
    bench["configs"].append({"name": "qwen2-tiny", "source": c["source"],
                             "file": "chipbench/configs/qwen2-tiny.json",
                             "reduced": ["num_hidden_layers"], "why": "a test's"})
    bench["workloads"].append({"name": "qwen2-tiny.short-prefill", "config": "qwen2-tiny",
                               "traffic": "short-prefill", "chips": 1, "why": "a test's"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "qwen2-72b.long-prefill" in m.get("workloads", []):
            m["workloads"].append("qwen2-tiny.short-prefill")
    bench["per_layer"].append({"name": "calls_done.prefill", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "serving steps",
                               "moves": "prefill_tokens_per_s",
                               "workloads": ["qwen2-tiny.short-prefill"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out, _ = harness.run_cell("qwen2-tiny.short-prefill", 3, 0.2, True, torch.device("cpu"),
                              0.0, root=tmp_path)
    assert out["correct"] and out["metrics"]["calls_done.prefill"]["value"] >= 1
    assert "mfu_pct.prefill" in out["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())
