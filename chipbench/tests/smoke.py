"""Smoke sizes of the benchmark's configurations and traffic, for the CPU
tests: every width cut, the equations and the files' other keys kept."""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
WIDTHS = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
          "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
          "vocab_size": 256, "state_size": 8, "time_step_rank": 4}
TRAFFIC = {"prefill": {"prompt_lengths": [16, 32, 64]},
           "decode": {"sessions": 4, "groups": 2, "prompt_len": 8, "max_len": 40,
                      "max_new": 32}}
CELLS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])
# windows on the step clock: ~10 prefill calls; ~40 decode steps, past
# each group's refill (its answer ends 5 and 21 steps in)
WINDOW = {"prefill": 0.02, "decode": 0.12}


class StepClock:
    """A host clock that moves 1 ms each time it is read, so that a window
    holds the same requests however loaded the machine is."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


def config(name: str, root: Path = ROOT) -> dict:
    c = json.loads((root / "chipbench" / "configs" / f"{name}.json").read_text())
    return {**c, **{k: v for k, v in WIDTHS.items() if k in c}}


def workload(cell: str, root: Path = ROOT) -> dict:
    w = json.loads((root / "chipbench" / "workloads" / f"{cell}.json").read_text())
    return {**w, **TRAFFIC[w["loop"]]}


def config_of(cell: str) -> dict:
    return config(cell.split(".")[0])
