"""Architecture configuration: the attention-only subset of the reference's
``ArchConfig`` (``repro/configs/base.py``), as a plain frozen dataclass.

Only the fields the dense/local/global attention path reads are kept; the
MoE, SSM, RG-LRU, prefix-LM and sharding fields belong to later slices.
"""
from __future__ import annotations

import dataclasses

BLOCK_KINDS = ("dense", "local", "global")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_pattern: tuple[str, ...] = ("dense",)

    attn_window: int = 0          # local-attention window
    attn_softcap: float = 0.0     # attention logit soft-capping
    logit_softcap: float = 0.0    # final-logit soft-capping
    query_scale: float = 0.0      # 0 -> 1/sqrt(head_dim)
    rope_theta: float = 10_000.0

    mlp_act: str = "silu"         # silu | gelu (tanh) | relu
    mlp_glu: bool = True

    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma: * sqrt(d_model), (1+w) norms
    norm_eps: float = 1e-6
    post_norms: bool = False

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True

    def __post_init__(self):
        bad = [k for k in self.layer_pattern if k not in BLOCK_KINDS]
        if bad:
            raise ValueError(f"layer kinds {bad} are not ported; "
                             f"supported: {BLOCK_KINDS}")
        if "local" in self.layer_pattern and self.attn_window <= 0:
            raise ValueError("local layers need attn_window > 0")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), as the reference
        computes it for the attention kinds."""
        M, V = self.d_model, self.vocab_size
        n = V * M if self.tie_embeddings else 2 * V * M
        per_layer = (M * self.n_heads * self.head_dim * 2
                     + M * self.n_kv_heads * self.head_dim * 2
                     + M * self.d_ff * (3 if self.mlp_glu else 2)
                     + 2 * M)
        return n + per_layer * self.n_layers

    def smoke(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's reduction)."""
        period = len(self.layer_pattern)
        n_layers = period + 1 if self.n_layers > period else period
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 2)
                        if self.n_kv_heads < self.n_heads else 4),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            attn_window=min(self.attn_window, 32) if self.attn_window else 0,
        )
