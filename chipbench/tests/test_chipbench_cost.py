"""The frozen yardstick's arithmetic on shapes whose counts are known."""
import itertools
import json

import pytest

from chipbench.cost import flash_attention, model, peaks, ssm_scan
from chipbench.tests import smoke


def _brute_visible(Sq, Sk):
    off = Sk - Sq
    return sum(1 for i, j in itertools.product(range(Sq), range(Sk)) if j <= off + i)


@pytest.mark.parametrize("Sq,Sk", [(1, 1), (7, 7), (3, 10), (1, 2304)])
def test_visible_keys_count_the_causal_mask(Sq, Sk):
    assert flash_attention.visible_keys(Sq, Sk) == _brute_visible(Sq, Sk)


def test_flash_cost_at_the_long_prefill_and_the_programs_count():
    from repro_torch.kernels.flash_attention.cost import flash_cost

    c = flash_attention.cost(1, 32768, 32768, 64, 8, 128)
    assert c["flops"] == 4 * 64 * 128 * 32768 * 32769 // 2
    assert c["bytes"] == (2 * 32768 * 64 + 2 * 32768 * 8) * 128 * 2
    assert c == flash_cost(1, 32768, 32768, 64, 8, 128, 2, True, 0)
    # FLOP-bound at this size: the least time is its operations' time
    assert flash_attention.least_seconds(1, 32768, 32768, 64, 8, 128) == \
        c["flops"] / peaks.BF16_FLOPS


def test_scan_cost_by_hand():
    c = ssm_scan.cost(B=1, S=2, di=3, N=4)
    assert c["exps"] == 24 and c["f32_flops"] == 2 * 3 * 25
    assert c["bytes"] == 2 * 3 * 8 + 2 * 2 * 4 * 2 + 3 * 4 * 4 + 2 * 3 * 4 * 4
    # the falcon-mamba prefill call is bound by the SFU's exponentials
    big = ssm_scan.cost(4, 16384, 8192, 16)
    assert ssm_scan.least_seconds(4, 16384, 8192, 16) == big["exps"] / peaks.SFU_EXPS


def test_peaks_take_the_largest_bound():
    assert peaks.least_seconds(flops=989e12) == 1.0
    assert peaks.least_seconds(flops=1.0, nbytes=3.35e12) == 1.0
    assert peaks.least_seconds(exps=peaks.SFU_EXPS * 2) == 2.0


def test_step_counts_of_the_qwen2_stage():
    c = json.loads((smoke.ROOT / "chipbench/configs/qwen2-72b.json").read_text())
    M, F, V = 8192, 29568, 152064
    layer = M * 64 * 128 * 2 + M * 8 * 128 * 2 + 3 * M * F
    assert layer == 877_658_112
    one = model.step(c, B=1, S=1, past=0, logit_rows=1)
    assert one["flops"] == 2.0 * 10 * layer + 10 * 4 * 64 * 128 + 2.0 * M * V
    # decode: 256 rows at position 1000 read their KV cache (1001 slots) once
    dec = model.step(c, B=256, S=1, past=1000, logit_rows=256)
    weights = 10 * (layer * 2 + 4 * (2 * M + 64 * 128 + 2 * 8 * 128)) + 2 * M * V + 4 * M
    kv = 10 * 2 * 256 * 1001 * 8 * 128 * 2
    assert dec["bytes"] == weights + kv + 2 * M * 256
    assert model.least_seconds(c, 256, 1, 1000, 256) == dec["bytes"] / peaks.HBM_BYTES


def test_step_counts_of_falcon_mamba():
    c = json.loads((smoke.ROOT / "chipbench/configs/falcon-mamba-7b.json").read_text())
    M, di, N, K, R = 4096, 8192, 16, 4, 256
    products = M * 2 * di + di * (R + 2 * N) + R * di + di * M
    s = model.step(c, B=4, S=4096, past=0, logit_rows=4)
    per_token = 2 * products + 2 * K * di + di * (6 * N + 1)
    assert s["flops"] == 64 * 4 * 4096 * per_token + 2.0 * M * 65024 * 4
