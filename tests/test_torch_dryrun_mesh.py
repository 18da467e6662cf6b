"""Port parity for the dry run's collectives and the remat policies on a
(data, model) mesh of 1x2: a training step of each layer kind at smoke
size counted on an abstract mesh (``launch.dryrun.count_step``) records
the collectives a real 2-rank gloo run of the same step records; "comm"
saves the recomputed forward all-reduces, ``lowp_collectives`` halves the
partial sums' bytes (the remat policies' gradients:
``test_torch_remat.py``).

Tolerances: none (the records are integers).
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
import _torch_tp_ref as R  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402

SMOKE_TRAIN = ShapeConfig("smoke", _torch_dist.S, _torch_dist.B, "train")


# -- collectives on meta against a real run --------------------------------------


KIND_JOBS = ([{"arch": a, "cfg_kw": {"remat": r}, "lowp": False}
              for a in R.KINDS for r in ("full", "comm")]
             + [{"arch": a, "cfg_kw": {"remat": "full", "compute_dtype": "bfloat16"},
                 "lowp": lp} for a in ("gemma3-4b", "falcon-mamba-7b") for lp in (False, True)])


@pytest.fixture(scope="module")
def real_records():
    return run_ranks(_torch_dist.collective_records, 2, (1, 2), R.AXES2, KIND_JOBS)


def _dry_record(job, rank):
    cfg = _torch_dist.smoke_config(job["arch"], **job["cfg_kw"])
    rep = dryrun.count_step(cfg, SMOKE_TRAIN, AbstractMesh((1, 2), R.AXES2, rank),
                            lowp=job["lowp"])
    return {"bytes": rep["collective_bytes"], "counts": rep["collective_counts"],
            "dtype_bytes": rep["collective_dtype_bytes"]}


@pytest.mark.parametrize("i", range(len(KIND_JOBS)),
                         ids=[f"{j['arch']}-{j['cfg_kw']['remat']}"
                              f"{'-bf16' if len(j['cfg_kw']) > 1 else ''}"
                              f"{'-lowp' if j['lowp'] else ''}" for j in KIND_JOBS])
def test_dry_run_collectives_equal_a_real_two_rank_run(i, real_records):
    """A training step of each layer kind at smoke size on an abstract 1x2
    mesh records, on each rank, the collectives a real 2-rank gloo run of
    the same step records: class by class, bytes, counts and dtypes."""
    for rank in range(2):
        assert _dry_record(KIND_JOBS[i], rank) == real_records[rank][i]


def test_comm_remat_saves_the_recomputed_forward_all_reduces(real_records):
    """gemma3-4b smoke (7 attention layers with post norms): "comm" issues
    14 fewer all-reduces than "full", the two forward sums a layer
    (attention and MLP output) that the recompute takes from the forward,
    with their bytes; falcon-mamba's recompute stops before its block's
    output sum (nothing after it is saved), and its x_proj sum, which the
    scan's backward needs, is issued again under both."""
    rec = {(j["arch"], j["cfg_kw"]["remat"]): real_records[0][i]
           for i, j in enumerate(KIND_JOBS) if not j["lowp"] and len(j["cfg_kw"]) == 1}
    cfg = _torch_dist.smoke_config("gemma3-4b")
    full, comm = rec[("gemma3-4b", "full")], rec[("gemma3-4b", "comm")]
    n = 2 * cfg.n_layers
    assert full["counts"]["all-reduce"] - comm["counts"]["all-reduce"] == n == 14
    row = _torch_dist.B * _torch_dist.S * cfg.d_model * 4
    assert full["bytes"]["all-reduce"] - comm["bytes"]["all-reduce"] == n * row
    assert rec[("falcon-mamba-7b", "full")] == rec[("falcon-mamba-7b", "comm")]


def test_lowp_halves_the_partial_sum_bytes(real_records):
    """In bf16 compute, the row-parallel partial sums ride the wire in
    bf16 under ``lowp_collectives``: their f32 bytes become half as many
    bf16 bytes, and no other all-reduce changes."""
    by = {(j["arch"], j["lowp"]): real_records[0][i]["dtype_bytes"]["all-reduce"]
          for i, j in enumerate(KIND_JOBS) if len(j["cfg_kw"]) == 2}
    for arch in ("gemma3-4b", "falcon-mamba-7b"):
        f32, lowp = by[(arch, False)], by[(arch, True)]
        assert "torch.bfloat16" not in f32
        moved = f32["torch.float32"] - lowp["torch.float32"]
        assert moved > 0 and lowp["torch.bfloat16"] * 2 == moved, arch
