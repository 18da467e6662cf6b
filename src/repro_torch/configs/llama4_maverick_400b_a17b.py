"""llama4-maverick-400b-a17b — MoE 128e top-1, early fusion (frontend stub).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] Spec: 48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1. Interpreted per the released
Maverick layout: MoE every other layer (interleave step 2) with an always-on
shared expert — this reproduces ~400B total / ~17B active.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    layer_pattern=("dense", "moe"),
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192, shared_expert=True),
    rope_theta=500_000.0,
    mlp_act="silu",
)
