"""recurrentgemma-9b — Griffin: RG-LRU + local attention, attn:rglru = 1:2.

[arXiv:2402.19427; unverified] 38L d_model=4096 16H (GQA kv=1, MQA)
d_ff=12288 vocab=256000, window 2048, pattern (R, R, A).
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    layer_pattern=("rglru", "rglru", "local"),
    attn_window=2048,
    rglru=RGLRUConfig(d_rnn=4096, d_conv=4, block_width=256),
    tie_embeddings=True,
    scale_embeddings=True,
    mlp_act="gelu",
)
