"""paligemma-3b — SigLIP vision frontend (STUB) + gemma-2b text backbone.

[arXiv:2407.07726; hf] 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.
input_specs() supplies 256 precomputed patch embeddings prepended to the text;
prefix attends bidirectionally (prefix-LM), suffix is causal.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    layer_pattern=("dense",),
    frontend="vision_patches",
    n_prefix=256,
    prefix_bidirectional=True,
    tie_embeddings=True,
    scale_embeddings=True,
    mlp_act="gelu",
)
