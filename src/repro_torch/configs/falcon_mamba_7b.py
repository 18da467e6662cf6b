"""falcon-mamba-7b — attention-free mamba1 SSM.

[arXiv:2410.05355; unverified] 64L d_model=4096 d_ff=0 vocab=65024,
ssm_state=16, conv 4, expand 2 (d_inner 8192), dt_rank 256.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=65_024,
    layer_pattern=("mamba",),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    mlp_act="silu",
)
