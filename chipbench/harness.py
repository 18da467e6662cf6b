"""One run of one cell: set-up, the timed window, the metrics, the check.

Everything that belongs to one cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``chipbench/configs/<name>.json``
by the configuration's ``file``) and its workload file
(``chipbench/workloads/<cell>.json``), which names its loop
(``chipbench/loops/<loop>.py``); each metric the cell reports is read
by ``chipbench/metrics/<metric>.py``.

The program is driven through its serving steps:
``repro_torch.train.serve_step.ServeSetup`` over ``repro_torch.models.Model``,
the steps ``launch/serve.py::serve`` runs.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from chipbench import check, port, tracing, weights
from chipbench.weights import seed64

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def root_of() -> Path:
    return HERE.parent


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_file(root: Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def workload_file(root: Path, cell: str) -> dict:
    return json.loads((root / "chipbench" / "workloads" / f"{cell}.json").read_text())


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's metrics of this kind of run: its end-to-end ones untraced,
    its per-layer ones traced; a metric with a ``workloads`` list is the
    listed cells' alone."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def untraced(m: dict) -> bool:
    """Whether a metric is read from a window the profiler does not record:
    every one but those taken from the device's trace, so that the
    profiler's cost on the host is in none of them."""
    return m["source"] != "device_trace"


def reader(root: Path, name: str):
    """``chipbench/metrics/<name>.py`` under ``root`` (a name may hold dots)."""
    path = root / "chipbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "chipbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """The JAX stack or the JAX package, by whole top-level names."""
    tops = {m.partition(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a loop sees: the program's serving steps over the raw
    weights, the seed's prompts, the clock and the device."""
    seed: int
    device: torch.device
    config: dict
    workload: dict
    weights: dict
    serve: Any
    params: Any
    clock: Callable[[], float] = time.perf_counter

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prompt(self, stream: int, index: int, rows: int, length: int) -> np.ndarray:
        """Token ids (rows, length) of one request, from the seed alone."""
        rng = np.random.default_rng([seed64(self.seed), stream, index])
        return rng.integers(0, self.config["vocab_size"], size=(rows, length),
                            dtype=np.int64)


@dataclasses.dataclass
class Context:
    """What a metric's reader sees."""
    config: dict
    workload: dict
    records: dict
    setup_s: float
    trace: Optional[dict]


@dataclasses.dataclass
class Cell:
    """A cell set up for its window: its files, the raw weights, the
    loop, what the loop sees and what set-up left."""
    bench: dict
    entry: dict
    loop: Any
    run: Run
    state: dict


def prepare(cell: str, seed: int, device: torch.device, root: Path, *,
            config: Optional[dict] = None, workload: Optional[dict] = None,
            clock: Callable[[], float] = time.perf_counter) -> Cell:
    """Everything before the window: the program's configuration and
    parameters over the seed's raw weights, and the loop's set-up.
    ``config``, ``workload`` and ``clock`` stand in for the cell's files
    and the host's clock (the tests' smoke sizes and a clock that does
    not depend on the machine's load)."""
    from repro_torch.models import Model
    from repro_torch.train.serve_step import ServeSetup

    bench = load_benchmark(root)
    entry = cell_entry(bench, cell)
    c = config or config_file(root, bench, entry["config"])
    w = workload or workload_file(root, cell)
    loop = importlib.import_module(f"chipbench.loops.{w['loop']}")
    with torch.inference_mode():
        model = Model(port.arch_config(c))
        raw = weights.make(c, seed, device)
        params = port.params(model, c, raw)
        run = Run(seed, device, c, w, raw, ServeSetup(model), params, clock)
        state = loop.setup(run)
    return Cell(bench, entry, loop, run, state)


def window(cell: Cell, seconds: float, trace: bool) -> tuple[dict, Optional[dict]]:
    """The timed window: (the loop's records, the trace's summary)."""
    tr = tracing.Trace(trace, cell.run.device)
    with torch.inference_mode():
        records = cell.loop.window(cell.run, cell.state, seconds, tr)
        cell.run.sync()
    return records, tr.summary()


def served(cell: Cell, records: dict) -> list[dict]:
    """The sample of served outputs the check judges, drawn from the seed;
    the program's state is let go."""
    rng = random.Random(seed64(cell.run.seed))
    items = cell.loop.served(cell.run, cell.state, records, rng,
                               cell.run.workload["check"]["sample"])
    cell.state.clear()
    cell.run.params = None
    if cell.run.device.type == "cuda":
        torch.cuda.empty_cache()
    return items


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, *,
             root: Optional[Path] = None, config: Optional[dict] = None,
             workload: Optional[dict] = None,
             clock: Callable[[], float] = time.perf_counter) -> tuple[dict, list[str]]:
    """One run. Returns (the result line's object, the check's lines)."""
    root = root or root_of()
    cl = prepare(cell, seed, device, root, config=config, workload=workload,
                 clock=clock)
    wanted = metrics_of(cl.bench, cell, trace)
    # a traced run reads its other metrics from a window of its own, run
    # first and not recorded, as an untraced run would read them
    plain = None
    if trace and any(untraced(m) for m in wanted):
        plain, _ = window(cl, seconds, False)
    records, summary = window(cl, seconds, trace)
    setup_s = (plain or records)["t0"] - t_start
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)

    ctx = Context(cl.run.config, cl.run.workload, records, setup_s, summary)
    plain_ctx = Context(cl.run.config, cl.run.workload, plain, setup_s, None)
    metrics = {}
    for m in wanted:
        value = reader(root, m["name"]).read(
            plain_ctx if plain is not None and untraced(m) else ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = records["attempted"] + (plain["attempted"] if plain else 0)

    items = served(cl, records)
    del records, plain, ctx, plain_ctx
    t_check = time.perf_counter()
    found = check.numbers(cl.run.config, cl.run.weights, items, device)
    correct, checks = check.judge(found, cl.run.workload["check"]["limits"])
    print(f"[chipbench] check: {time.perf_counter() - t_check:.1f} s over "
          f"{found['n_tokens']} served tokens", file=sys.stderr)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else device.type),
           "count": cl.entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = tracing.breakdown(summary)
    result["checks"] = checks
    lines = [f"check {n}: {v['value']} limit {v['limit']}" for n, v in checks.items()]
    return result, lines
