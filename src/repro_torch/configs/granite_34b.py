"""granite-34b — llama-architecture code model, MQA.

[arXiv:2405.04324; hf] 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49_152,
    layer_pattern=("dense",),
    mlp_act="gelu",
)
