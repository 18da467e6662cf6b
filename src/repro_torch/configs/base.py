"""Architecture configuration: the subset of the reference's ``ArchConfig``
(``repro/configs/base.py``) that the ported kinds read, as a plain frozen
dataclass.

Only the fields the dense/local/global attention and mamba paths and the
single-device training path read are kept; the MoE, RG-LRU, prefix-LM and
sharding fields belong to later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

BLOCK_KINDS = ("dense", "local", "global", "mamba")
ATTN_KINDS = ("dense", "local", "global")


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


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

    ssm: Optional[SSMConfig] = None

    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma: * sqrt(d_model), (1+w) norms
    norm_eps: float = 1e-6
    post_norms: bool = False

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"           # none | full | dots | comm (block remat)
    scan_layers: bool = True

    def __post_init__(self):
        bad = [k for k in self.layer_pattern if k not in BLOCK_KINDS]
        if bad:
            raise ValueError(f"layer kinds {bad} are not ported; "
                             f"supported: {BLOCK_KINDS}")
        if "local" in self.layer_pattern and self.attn_window <= 0:
            raise ValueError("local layers need attn_window > 0")
        if "mamba" in self.layer_pattern and self.ssm is None:
            raise ValueError("mamba layers need an SSMConfig")

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Kind of every layer, 0..n_layers-1 (pattern tiled + truncated)."""
        p = self.layer_pattern
        return (p * -(-self.n_layers // len(p)))[: self.n_layers]

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), as the reference
        computes it for the ported kinds."""
        M, V = self.d_model, self.vocab_size
        n = V * M if self.tie_embeddings else 2 * V * M
        for kind in self.layer_kinds:
            if kind in ATTN_KINDS:
                n += (M * self.n_heads * self.head_dim * 2
                      + M * self.n_kv_heads * self.head_dim * 2
                      + M * self.d_ff * (3 if self.mlp_glu else 2))
            elif kind == "mamba":
                s = self.ssm
                di, dr = self.d_inner, s.resolved_dt_rank(M)
                n += (M * 2 * di                  # in_proj
                      + di * s.d_conv             # conv
                      + di * (dr + 2 * s.d_state)  # x_proj
                      + dr * di                   # dt_proj
                      + di * s.d_state + 2 * di   # A_log, D, dt bias-ish
                      + di * M)                   # out_proj
            n += 2 * M                            # pre-norms (approx.)
        return n

    def smoke(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's reduction)."""
        period = len(self.layer_pattern)
        n_layers = period + 1 if self.n_layers > period else period
        ssm = dataclasses.replace(self.ssm, d_state=8) if self.ssm else None
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
            ssm=ssm,
            remat="none",
        )
