"""Port parity for the remat policies on a (data, model) mesh of 1x2
(``models/transformer.py``: "full", "dots" with the selective checkpoint
policy of ``checkpoint_dots_with_no_batch_dims``, "comm" keeping the
post-all-reduce sublayer outputs): gemma2-27b smoke in f32 against the
reference's jitted one-device step under each policy, and "dots" and
"comm" against "full" bit for bit.

Tolerances: the gates of ``tests/_torch_tp_ref.py`` (loss 1e-5, grad norm
1e-4, params at LR 0 1e-4, moments 5e-4, step 2's update 5e-2); none
between the policies.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
import _torch_tp_ref as R  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402


# -- the remat policies -------------------------------------------------------------


REMAT = ["full", "dots", "comm"]


@pytest.fixture(scope="module")
def remat_at_1x2():
    jobs = [R.steps_job("gemma2-27b", (("remat", r),)) for r in REMAT]
    return run_ranks(_torch_dist.tp_jobs, 2, (1, 2), R.AXES2, jobs)


@pytest.mark.parametrize("remat", REMAT)
def test_remat_policies_give_full_remats_gradients(remat, remat_at_1x2):
    """gemma2-27b smoke in f32 at 1x2 under "full", "dots" and "comm":
    each against the reference's jitted one-device step under the same
    policy (its gates), and "dots" and "comm" bit for bit "full"'s:
    metrics, and the moments after the first step (which hold the
    gradients)."""
    got = [g[REMAT.index(remat)] for g in remat_at_1x2]
    R.hold("gemma2-27b", got, (("remat", remat),))
    full = remat_at_1x2[0][0]
    assert got[0]["metrics"] == full["metrics"]
    for part in ("params", "mu", "nu"):
        assert R.bit_equal(got[0]["snapshots"][0][part], full["snapshots"][0][part])
