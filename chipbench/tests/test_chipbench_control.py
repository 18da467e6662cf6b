"""On the card only: at each cell's own size, the program's numbers keep
within the cell's limits and the control's (the reference in fp8 in the
program's place, on the same served sample) break at least one of them.
Run on the card with ``python3 -m pytest -q chipbench/tests -m cuda``."""
import json

import pytest
import torch

from chipbench import check, control, harness
from chipbench.tests import smoke

BENCH = json.loads((smoke.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCH["workloads"]))
def test_the_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own sizes")
    w = harness.workload_file(smoke.ROOT, cell)
    out = control.readings(cell, 2**31 + 77, w["check"]["control_seconds"], True,
                           torch.device("cuda", 0))
    limits = w["check"]["limits"]
    assert check.judge(out["program"], limits)[0], out
    assert not check.judge(out["control"], limits)[0], out
