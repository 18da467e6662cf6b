"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W limit): bfloat16 tensor cores, float32 outside the
tensor cores, HBM3; and the SFU's exponentials, 16 a clock per SM
(NVIDIA's throughput table for compute capability 9.0) on 132 SMs at the
1.98 GHz boost clock that the float32 rate assumes."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
SFU_EXPS = 132 * 16 * 1.98e9


def least_seconds(flops: float = 0.0, nbytes: float = 0.0, exps: float = 0.0,
                  f32_flops: float = 0.0) -> float:
    """The least time the card can take for this work: the largest of its
    bf16 operations, float32 operations, exponentials and bytes, each over
    its peak."""
    return max(flops / BF16_FLOPS, f32_flops / F32_FLOPS, exps / SFU_EXPS,
               nbytes / HBM_BYTES)
