"""arctic-480b — 128 experts top-2 + dense residual MLP in every layer.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2, dense-MoE hybrid residual.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    layer_pattern=("moe",),
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864, dense_residual=True),
    rope_theta=10_000.0,
    mlp_act="silu",
)
