"""Port parity for the dry run: ``repro_torch/configs/base.py``'s shapes
(``ShapeConfig``, ``SHAPES``, ``shape_applicable``, ``input_specs``,
``flops_per_step``), the abstract state on the production meshes,
``launch/op_analysis.py`` (the twin of ``repro/launch/hlo_analysis.py``),
the kernels' meta paths and their cost formulas, and
``launch/dryrun.py``'s command line (the collective record against a real
run and the remat policies: ``test_torch_dryrun_mesh.py``).

Tolerances: none. Configs, shapes and counts are integers or sums of them
and must be equal.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import flops_per_step as jflops_per_step  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import input_specs as jinput_specs  # noqa: E402
from repro.configs import shape_applicable as jshape_applicable  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.layers import is_spec, param_shardings  # noqa: E402
from repro.train.sharding import make_rules as jmake_rules  # noqa: E402
from repro_torch.configs import (SHAPES, flops_per_step,  # noqa: E402
                                 get_config, input_specs, shape_applicable)
from repro_torch.kernels.flash_attention.cost import flash_cost  # noqa: E402
from repro_torch.kernels.flash_attention.ops import gqa_attention  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.cost import scan_cost  # noqa: E402
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, abstract_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import TrainConfig, TrainSetup  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- configs ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_flops_and_params_equal_the_reference(arch):
    """For each of the four shapes: ``shape_applicable`` (reason too),
    ``flops_per_step``, ``param_count`` and ``active_param_count`` exactly,
    and ``input_specs``' keys, shapes and dtypes."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert list(SHAPES) == list(JSHAPES)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        assert shape_applicable(cfg, shape) == jshape_applicable(jcfg, jshape)
        assert flops_per_step(cfg, shape) == jflops_per_step(jcfg, jshape)
        got, want = input_specs(cfg, shape), jinput_specs(jcfg, jshape)
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape)
            assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype)


def _reference_shard_shapes(arch, mesh_kind):
    """{path: shard shape} of the reference's params on an AbstractMesh."""
    shape, axes = MESHES[mesh_kind]
    amesh = jax.sharding.AbstractMesh(shape, axes)
    jcfg = jax_config(arch)
    specs = JaxModel(jcfg).param_specs()
    shards = param_shardings(specs, amesh, jmake_rules(amesh, jcfg))
    out = {}
    for (path, spec), sh in zip(
            jax.tree_util.tree_leaves_with_path(specs, is_leaf=is_spec),
            jax.tree.leaves(shards)):
        out["/".join(str(k.key) for k in path)] = tuple(sh.shard_shape(spec.shape))
    return out


def _port_shapes(tree, prefix=""):
    """{path: shape} of the port's tree; a scan entry's periods as
    path -> [shape per period]."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_port_shapes(v, p))
        elif isinstance(v, list):
            for period in v:
                for q, s in _port_shapes(period, p).items():
                    out.setdefault(q, []).append(s)
        else:
            out[p] = tuple(v.shape)
    return out


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_state_holds_the_reference_shard_shapes(arch, mesh_kind):
    """Rank 0's params of ``TrainSetup.abstract_state()`` on the abstract
    production mesh, leaf by leaf, have the reference's shard shape on a
    ``jax.sharding.AbstractMesh``; a stacked ``scan`` leaf is the port's
    list of periods, each the shard shape without the periods axis. All
    meta tensors."""
    setup = TrainSetup(Model(get_config(arch)), TrainConfig(), abstract_mesh(mesh_kind))
    state = setup.abstract_state()
    got = _port_shapes(state["params"])
    want = _reference_shard_shapes(arch, mesh_kind)
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if isinstance(g, list):
            assert g == [w[1:]] * w[0], path
        else:
            assert g == w, path
    leaves = torch.utils._pytree.tree_leaves(state)
    assert all(t.device.type == "meta" for t in leaves)


def test_dry_run_argument_bytes_are_the_state_and_rows():
    """A cell's ``argument_bytes`` is the bytes of this rank's state and
    batch rows, and its flops and model flops are counted."""
    cfg = get_config("gemma2-27b")
    shape = SHAPES["train_4k"]
    mesh = abstract_mesh("single")
    fn, (state, batch) = dryrun.build_step(cfg, shape, mesh)
    want = op_analysis.tree_bytes(state) + op_analysis.tree_bytes(batch)
    rep = dryrun.count_step(cfg, shape, mesh)
    assert rep["argument_bytes"] == want
    assert rep["flops"] > flops_per_step(cfg, shape) / mesh.size


# -- the op counter -----------------------------------------------------------


def test_matmul_loop_counts_every_iteration():
    """The twin of the reference's scan-of-matmuls trip count: ten
    (128, 128) products in a Python loop count 10 * 2 * 128**3."""
    x, w = torch.randn(128, 128), torch.randn(128, 128)

    def loop(x, w):
        for _ in range(10):
            x = x @ w
        return x
    _, rep = op_analysis.analyze(loop, x, w)
    assert rep["flops"] == 10 * 2 * 128 ** 3
    assert rep["n_ops"] == 10


def test_batched_einsum_counts_batch_and_contracting_dims():
    a, b = _meta(4, 8, 16), _meta(4, 16, 32)
    _, rep = op_analysis.analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b), a, b)
    assert rep["flops"] == 2 * 4 * 8 * 32 * 16


def test_views_add_no_bytes_and_pointwise_ops_count_their_elements():
    x = _meta(64, 32)
    _, rep = op_analysis.analyze(lambda x: x.view(32, 64).t()[3:].unsqueeze(0), x)
    assert rep["hbm_bytes"] == 0 and rep["n_ops"] == 0
    _, rep = op_analysis.analyze(lambda x: x * 2.0, x)
    assert rep["vpu_flops"] == 64 * 32
    assert rep["hbm_bytes"] == 2 * 64 * 32 * 4


def test_peak_follows_each_storage_from_its_op_until_it_is_freed():
    """Arguments 4096 B; a 4096 B result, then a 40960 B one, the first
    freed before a third of 2048 B: the peak is the arguments plus the two
    first."""
    x = _meta(1024)

    def allocs(x):
        a = x + 1.0                    # 4096
        b = torch.cat([a] * 10)         # 40960
        del a
        c = b[:512] * 2.0               # 2048
        return c
    _, rep = op_analysis.analyze(allocs, x)
    assert rep["argument_bytes"] == 4096
    assert rep["peak_bytes"] == 4096 + 4096 + 40960


def test_each_collective_class_records_its_wire_bytes():
    """On an abstract group of 4: an all-reduce its tensor's bytes, an
    all-gather (or a gather to one rank) four times them, a send, a
    broadcast and a ring hop the bytes they move, one count each, and the
    shapes of what they return; a group of one records nothing."""
    mesh = AbstractMesh((1, 4), ("data", "model"), rank=1)
    g, one = mesh.groups["model"], mesh.groups["data"]
    t = _meta(10, 6)

    def run(t):
        assert g.all_reduce_sum(t) is t
        assert [tuple(p.shape) for p in g.all_gather(t)] == [(10, 6)] * 4
        assert g.gather(t, 0) is None and len(g.gather(t, 1)) == 4
        g.send_to(t, 1, 2)
        g.send_to(t, 2, 3)              # rank 1 takes no part
        g.broadcast(t, 0)
        g.exchange(t, 2, _meta(20, 6), 0)
        one.all_reduce_sum(t)
    _, rep = op_analysis.analyze(run, t)
    n = 10 * 6 * 4
    assert rep["collective_bytes"] == {"all-reduce": n, "all-gather": 3 * 4 * n,
                                       "reduce-scatter": 0, "all-to-all": 0,
                                       "collective-permute": 4 * n}
    assert rep["collective_counts"] == {"all-reduce": 1, "all-gather": 3,
                                        "reduce-scatter": 0, "all-to-all": 0,
                                        "collective-permute": 3}
    assert (g.ranks, g.index, g.size) == ([0, 1, 2, 3], 1, 4)


def test_kernel_wrappers_on_meta_count_their_formulas():
    """The flash kernel's wrapper on meta returns the output's shape and
    counts 4·B·Hq·D·visible keys (not the plain version's S², which a
    window cuts), the scan's its own formula; nothing launches."""
    from repro_torch.kernels import LAUNCHES
    B, S, Hq, Hkv, D, W = 2, 96, 4, 2, 32, 16
    q, k = _meta(B, S, Hq, D, dtype=torch.bfloat16), _meta(B, S, Hkv, D, dtype=torch.bfloat16)
    before = dict(LAUNCHES)
    o, rep = op_analysis.analyze(
        lambda q, k: gqa_attention(q, k, k, causal=True, window=W), q, k)
    want = flash_cost(B, S, S, Hq, Hkv, D, 2, True, W)
    assert o.shape == q.shape and o.device.type == "meta"
    assert rep["flops"] == want["flops"] == 4 * B * Hq * D * (
        sum(min(i + 1, W) for i in range(S)))
    assert rep["kernels"]["flash_attention"] == {"calls": 1, **want}
    ins = (_meta(B, S, 64), _meta(B, S, 64), _meta(B, S, 8), _meta(B, S, 8),
           _meta(64, 8), _meta(B, 64, 8))
    (y, h), rep = op_analysis.analyze(scan_ops.selective_scan, *ins)
    assert (y.shape, h.shape) == ((B, S, 64), (B, 64, 8))
    assert rep["kernels"]["ssm_scan"]["flops"] == scan_cost(ins, (y, h))["flops"] \
        == B * S * 64 * (6 * 8 + 1)
    assert dict(LAUNCHES) == before


def _scan_grads_inputs(S, device, B=2, di=6, N=4):
    g = torch.Generator().manual_seed(0)
    ts = [torch.randn(B, S, di, generator=g), torch.rand(B, S, di, generator=g),
          torch.randn(B, S, N, generator=g), torch.randn(B, S, N, generator=g),
          -torch.rand(di, N, generator=g), torch.randn(B, di, N, generator=g),
          torch.randn(B, S, di, generator=g), torch.randn(B, di, N, generator=g)]
    return [t.to(device) for t in ts]


@pytest.mark.parametrize("chunk", [0, 3])
def test_scan_backward_trip_count_equals_the_plain_backward_run(chunk):
    """The selective scan's backward on meta (counted from one, two and
    three time steps, not run step by step) counts what the plain backward
    counts when it runs on the CPU at S 8 (and 13), in one chunk and in
    chunks of 3: flops, elementwise flops, bytes and ops. Its ops grow
    linearly in S (45 a step in one chunk); its bytes and elementwise flops
    quadratically (each step's slice gradient is added into a whole-chunk
    buffer)."""
    keys = ("flops", "vpu_flops", "hbm_bytes", "n_ops")
    ops = {}
    for S in (8, 13):
        _, cpu = op_analysis.analyze(
            lambda *a: scan_ops.scan_vjp(*a, chunk=chunk), *_scan_grads_inputs(S, "cpu"))
        grads, meta = op_analysis.analyze(
            lambda *a: scan_ops.scan_vjp(*a, chunk=chunk), *_scan_grads_inputs(S, "meta"))
        assert {k: cpu[k] for k in keys} == {k: meta[k] for k in keys}, S
        assert [tuple(g.shape) for g in grads] == [
            (2, S, 6), (2, S, 6), (2, S, 4), (2, S, 4), (6, 4), (2, 6, 4)]
        ops[S] = meta["n_ops"]
    if chunk == 0:
        assert ops[13] - ops[8] == 5 * 45


# -- the command line -------------------------------------------------------------------


def test_dryrun_cli_writes_a_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the single mesh writes the
    cell's JSON with the reference's fields; a pure full-attention arch at
    long_500k is skipped with the reference's reason."""
    env = {**os.environ, "PYTHONPATH": "src"}
    for arch, shape in (("gemma3-4b-smoke", "train_4k"),
                        ("qwen2-72b-smoke", "long_500k")):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--quiet",
             "--out", str(tmp_path)],
            capture_output=True, text=True, env=env, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / "gemma3-4b-smoke__train_4k__single.json").read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    for k in ("flops", "vpu_flops", "hbm_bytes", "model_flops", "collectives",
              "memory", "trace_s", "n_ops"):
        assert k in rec, k
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "peak_bytes"}
    assert rec["model_flops"] == flops_per_step(get_config("gemma3-4b-smoke"),
                                                SHAPES["train_4k"])
    assert rec["collectives"]["counts"]["all-reduce"] > 0
    skipped = json.loads((tmp_path / "qwen2-72b-smoke__long_500k__single.json").read_text())
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == jshape_applicable(jax_config("qwen2-72b"),
                                                  JSHAPES["long_500k"])[1]
    assert np.isfinite(rec["flops"])
