"""gemma3-4b — 5:1 local:global attention, 128k context, qk-norm.

[hf:google/gemma-3-1b-pt; unverified] 34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144, window 1024, local rope theta 10k / global 1M.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    attn_window=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    scale_embeddings=True,
    post_norms=True,
    mlp_act="gelu",
)
