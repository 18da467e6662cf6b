"""gemma2-27b — alternating local/global attention with logit soft-capping.

[arXiv:2408.00118; hf] 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000, window 4096, attn softcap 50, final-logit softcap 30,
query scale 1/sqrt(d_model/n_heads)=1/sqrt(144), not 1/sqrt(head_dim).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256_000,
    layer_pattern=("local", "global"),
    attn_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,
    tie_embeddings=True,
    scale_embeddings=True,
    post_norms=True,
    mlp_act="gelu",
)
