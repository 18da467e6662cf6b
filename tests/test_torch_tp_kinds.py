"""Port parity for training each layer kind on a (data, model) mesh of 1x2:
mamba (the scan on d_inner / 2 channels, ``x_proj``'s all-reduce in both
directions), RG-LRU with its MQA KV head shared by both ranks, MoE with
its experts over ``model`` and a shared expert, MQA with the prefix-LM
prefix (paligemma, 4 prefix embeddings before the tokens), and qk-norm
(gemma3). Two steps of each on two gloo processes against the reference's
jitted one-device step, under the gates ``test_torch_tp_train.py`` states;
and the sharded global norm with the shared KV head and the replicated q/k
norm scales against the whole tree's (1e-6 relative).
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
import _torch_tp_ref as R  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402

NORMS = ["recurrentgemma-9b", "gemma3-4b"]


@pytest.fixture(scope="module")
def at_1x2():
    """Every check of this file in one spawn of two ranks."""
    jobs = [R.steps_job(a) for a in R.KINDS] + [R.norm_job(a) for a in NORMS]
    return run_ranks(_torch_dist.tp_jobs, 2, (1, 2), R.AXES2, jobs)


@pytest.mark.parametrize("arch", R.KINDS)
def test_layer_kind_step_at_1x2(arch, at_1x2):
    R.hold(arch, [g[R.KINDS.index(arch)] for g in at_1x2])


@pytest.mark.parametrize("arch", NORMS)
def test_global_norm_counts_shared_kv_and_qk_norm_once(arch, at_1x2):
    want = R.whole_norm(arch)
    for g in at_1x2:
        assert g[len(R.KINDS) + NORMS.index(arch)] == pytest.approx(want, rel=1e-6)
