"""The port's checkpoints against the reference's, both ways, at both
layouts (3 layers: `rem`; 4: the stacked `scan`): a checkpoint the port
writes restores in the reference, and one the reference writes restores in
the port, with the same keys, files, dtypes, shapes and values bit for bit.
Then the port's Supervisor (restore after a failure, the restart budget),
its staged checkpoint, and ``plan_mesh`` against the reference's.

The train states are the reference's ``init_state`` with every leaf filled
from a numpy seed (moments, count and step nonzero), converted with
``train_state_from_jax``.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.runtime import plan_mesh as jax_plan_mesh  # noqa: E402
from repro.train import TrainSetup as JaxTrainSetup  # noqa: E402
from repro_torch.analysis import AnalysisSession, tar  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import to_reference_layout, train_state_from_jax  # noqa: E402
from repro_torch.core import (InTransitConfig, InTransitSink,  # noqa: E402
                              SavimeServer, StagingServer)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import ParamSpec  # noqa: E402
from repro_torch.runtime import (InjectedFailure, RestartBudgetExceeded,  # noqa: E402
                                 Supervisor, SupervisorConfig, plan_mesh)
from repro_torch.train import TrainSetup  # noqa: E402

CPU = torch.device("cpu")


def _setups(n_layers):
    jc = dataclasses.replace(jax_config("gemma2-27b").smoke(), n_layers=n_layers)
    tc = dataclasses.replace(get_config("gemma2-27b").smoke(), n_layers=n_layers)
    return JaxTrainSetup(JaxModel(jc), make_debug_mesh(1, 1)), \
        TrainSetup(Model(tc)), tc


def _reference_state(jts, seed=0):
    """The reference's state with every leaf filled from a numpy seed."""
    rng = np.random.default_rng(seed)
    st = jax.tree.map(np.asarray, jts.init_state(jax.random.PRNGKey(seed)))

    def fill(a):
        if a.dtype == np.int32:
            return np.asarray(rng.integers(1, 100), np.int32).reshape(a.shape)
        return rng.standard_normal(a.shape).astype(a.dtype)
    return jax.tree.map(fill, st)


def _abstract(tree):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)


def _assert_same_tree(ref, got):
    """``got`` (numpy, the reference's layout) equals ``ref``: keys, dtypes,
    shapes and bits."""
    rp = jax.tree_util.tree_leaves_with_path(ref)
    gp = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in rp] == [p for p, _ in gp]
    for (path, a), (_, b) in zip(rp, gp):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("n_layers", [3, 4])
def test_port_checkpoint_restores_in_the_reference(tmp_path, n_layers):
    jts, ts, tc = _setups(n_layers)
    ref_state = _reference_state(jts)
    state = train_state_from_jax(ref_state, tc, CPU)
    ckpt = CheckpointManager(str(tmp_path / "port"))
    ckpt.save(state, 7)
    ckpt.close()
    # the same files and manifest as the reference writes for that state
    jckpt = JaxCheckpointManager(str(tmp_path / "ref"), async_writes=False)
    jckpt.save(jax.tree.map(jnp.asarray, ref_state), 7)
    pdir, rdir = tmp_path / "port" / "step_00000007", tmp_path / "ref" / "step_00000007"
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(rdir))
    assert json.loads((pdir / "manifest.json").read_text()) == \
        json.loads((rdir / "manifest.json").read_text())
    if n_layers == 4:
        assert (pdir / "params__scan__0:local__ln1.npy").exists()
        assert np.load(pdir / "opt__mu__scan__1:global__attn__wq.npy").shape == (2, 64, 64)
    back = JaxCheckpointManager(str(tmp_path / "port")).restore(
        _abstract(ref_state))
    _assert_same_tree(ref_state, jax.tree.map(np.asarray, back))


@pytest.mark.parametrize("n_layers", [3, 4])
def test_reference_checkpoint_restores_in_the_port(tmp_path, n_layers):
    jts, ts, tc = _setups(n_layers)
    ref_state = _reference_state(jts, seed=1)
    jckpt = JaxCheckpointManager(str(tmp_path), async_writes=False)
    jckpt.save(jax.tree.map(jnp.asarray, ref_state), 3)
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_step() == 3
    state = ckpt.restore(ts.state_specs(), device="cpu")
    ckpt.close()
    if n_layers == 4:
        per = state["params"]["scan"]["0:local"]
        assert len(per) == 2 and per[1]["ln1"].shape == (64,)
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    assert state["opt"]["mu"]["embed"]["table"].dtype == torch.float32
    _assert_same_tree(ref_state, to_reference_layout(state))
    # and the restored state is one the port's step runs on
    want = to_reference_layout(train_state_from_jax(ref_state, tc, CPU))
    _assert_same_tree(want, to_reference_layout(state))


def test_save_copies_before_it_returns(tmp_path):
    """The caller may update its tensors in place as soon as save returns:
    the checkpoint holds the values at the call."""
    ts = TrainSetup(Model(get_config("gemma2-27b").smoke()))
    state = ts.init_state(0, "cpu")
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    ckpt.save(state, 1)
    before = to_reference_layout(state)
    for t in (state["params"]["embed"]["table"], state["opt"]["nu"]["final_ln"]):
        t.add_(1.0)
    ckpt.wait()
    _assert_same_tree(before, to_reference_layout(
        ckpt.restore(ts.state_specs(), device="cpu")))
    for step in (2, 3):
        ckpt.save(state, step)
    ckpt.close()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]


def _toy(tmp_path, sink=None):
    def step_fn(state, batch):
        new = {"w": state["w"] + batch["x"], "step": state["step"] + 1}
        return new, {"loss": new["w"].sum()}, {}

    state = {"w": torch.zeros(4), "step": torch.zeros((), dtype=torch.int32)}
    abstract = {"w": ParamSpec((4,)), "step": ParamSpec((), torch.int32)}
    batches = iter(lambda: {"x": torch.ones(4)}, None)
    ckpt = CheckpointManager(str(tmp_path), sink=sink, async_writes=False)
    return step_fn, state, abstract, batches, ckpt


def test_supervisor_restores_from_checkpoint(tmp_path):
    step_fn, state, abstract, batches, ckpt = _toy(tmp_path)
    sup = Supervisor(step_fn, ckpt, SupervisorConfig(ckpt_every=2,
                                                     max_restarts=2))
    out = sup.run(state, batches, 7, abstract_state=abstract, device="cpu",
                  fail_at={5})
    assert int(out["step"]) == 7 and sup.restarts == 1
    assert torch.equal(out["w"], torch.full((4,), 7.0))
    # the failure at step 5 rolls back to the checkpoint of step 4: step 5
    # runs twice
    assert [m["loss"] for m in sup.metrics_log] == \
        [4.0, 8.0, 12.0, 16.0, 20.0, 20.0, 24.0, 28.0]


def test_supervisor_restart_budget_exceeded(tmp_path):
    """Burning through max_restarts raises the typed error, carrying the last
    committed checkpoint step."""
    step_fn, state, abstract, batches, ckpt = _toy(tmp_path)

    def poisoned(state, batch):
        if int(state["step"]) >= 4:
            raise InjectedFailure("poisoned step")
        return step_fn(state, batch)

    sup = Supervisor(poisoned, ckpt, SupervisorConfig(ckpt_every=2,
                                                      max_restarts=2))
    with pytest.raises(RestartBudgetExceeded) as ei:
        sup.run(state, batches, 8, abstract_state=abstract, device="cpu")
    assert sup.restarts == 3 and ei.value.last_checkpoint_step == 4
    assert "step 4" in str(ei.value) and "max_restarts=2" in str(ei.value)


def test_supervisor_does_not_catch_a_plain_runtime_error(tmp_path):
    """Only the injected failure and the CUDA runtime's error type restart;
    any other error reaches the caller."""
    step_fn, state, abstract, batches, ckpt = _toy(tmp_path)

    def broken(state, batch):
        raise RuntimeError("a bug, not a device fault")

    sup = Supervisor(broken, ckpt)
    with pytest.raises(RuntimeError, match="a bug"):
        sup.run(state, batches, 3, abstract_state=abstract, device="cpu")
    assert sup.restarts == 0


def test_staged_checkpoint_is_queryable_in_savime(tmp_path):
    """With a sink, every checkpoint leaf is staged into SAVIME too."""
    savime = SavimeServer().start()
    staging = StagingServer(savime.addr, mem_capacity=64 << 20,
                            send_threads=2).start()
    try:
        sink = InTransitSink(staging.addr, InTransitConfig(tar_prefix="ckpt"))
        try:
            step_fn, state, abstract, batches, ckpt = _toy(tmp_path, sink)
            sup = Supervisor(step_fn, ckpt, SupervisorConfig(ckpt_every=2))
            out = sup.run(state, batches, 5, abstract_state=abstract,
                          device="cpu", fail_at={3})
            assert int(out["step"]) == 5 and sup.restarts == 1
            sink.flush()
            with AnalysisSession(savime.addr) as an:
                w = an.execute(tar("ckpt_ckpt_w").attr("v").select()).array
            # checkpoints at steps 2 and 4 (the failure at 3 rolls back to 2)
            # and at the end, 5
            assert w.shape == (4, 4)
            assert [row[0] for row in w[[0, 2, 3]].tolist()] == [2.0, 4.0, 5.0]
        finally:
            sink.close()
    finally:
        staging.stop()
        savime.stop()


def test_plan_mesh_matches_reference():
    for n in (16, 64, 256, 480, 512, 1024):
        assert plan_mesh(n) == jax_plan_mesh(n)
    with pytest.raises(ValueError):
        plan_mesh(24)
