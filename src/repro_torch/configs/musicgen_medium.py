"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf] 48L d_model=1536 24H (MHA, kv=24) d_ff=6144 vocab=2048.
The EnCodec audio frontend is a STUB (input is the token stream / precomputed
frame embeddings per DESIGN.md); plain (non-GLU) GELU FFN per the released
t5-style decoder.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    layer_pattern=("dense",),
    frontend="audio_frames",
    mlp_act="gelu",
    mlp_glu=False,
)
