"""Architecture configuration, the port of ``repro/configs/base.py``: the
reference's ``ArchConfig`` and its sub-configs as plain frozen dataclasses,
for every layer kind the reference has (dense, local, global, moe, mamba,
rglru) and its prefix-LM and frontend fields; and the dry run's input
shapes: ``ShapeConfig``, the reference's four ``SHAPES``,
``shape_applicable``, ``input_specs`` (meta tensors where the reference
gives ``ShapeDtypeStruct``s: shapes and dtypes, no storage) and
``flops_per_step`` (6ND or 2ND, the dry run's ``model_flops``).

Left out: ``attn_chunk`` (the reference's XLA chunk size; the port's
attention is the flash kernel or its plain version, neither of which takes
a chunk). ``pad_heads_to`` exists only for tensor-parallel sharding: inert query
heads, each KV group padded alike, so that ``model`` divides the heads
(``train.sharding.head_plan``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

BLOCK_KINDS = ("dense", "local", "global", "moe", "mamba", "rglru")
ATTN_KINDS = ("dense", "local", "global", "moe")   # the kinds with attention


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # expert hidden (ffn) width
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    shared_expert: bool = False   # llama4: always-on shared expert
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int = 0                # 0 -> d_model
    d_conv: int = 4
    block_width: int = 0          # diagonal-block input gates; 0 -> d_rnn


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
    pad_heads_to: int = 0         # inert q heads so heads % TP == 0 (must
                                  # keep pad_heads_to % n_kv_heads == 0)
    qkv_bias: bool = False
    attn_softcap: float = 0.0     # attention logit soft-capping
    logit_softcap: float = 0.0    # final-logit soft-capping
    qk_norm: bool = False         # gemma3 rms-norm on q/k
    query_scale: float = 0.0      # 0 -> 1/sqrt(head_dim)
    rope_theta: float = 10_000.0

    mlp_act: str = "silu"         # silu | gelu (tanh) | relu
    mlp_glu: bool = True

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma: * sqrt(d_model), (1+w) norms
    norm_eps: float = 1e-6
    post_norms: bool = False

    # modality frontend (a stub in the reference too: the caller passes
    # precomputed prefix embeddings)
    frontend: str = ""               # "" | "audio_frames" | "vision_patches"
    n_prefix: int = 0                # prefix embeddings prepended
    prefix_bidirectional: bool = False

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"           # none | full | dots | comm (block remat)
    scan_layers: bool = True

    def __post_init__(self):
        bad = [k for k in self.layer_pattern if k not in BLOCK_KINDS]
        if bad:
            raise ValueError(f"unknown layer kinds {bad}; known: {BLOCK_KINDS}")
        if "local" in self.layer_pattern and self.attn_window <= 0:
            raise ValueError("local layers need attn_window > 0")
        for kind, sub, field in (("moe", self.moe, "MoEConfig"),
                                 ("mamba", self.ssm, "SSMConfig"),
                                 ("rglru", self.rglru, "RGLRUConfig")):
            if kind in self.layer_pattern and sub is None:
                raise ValueError(f"{kind} layers need an {field}")
        if self.pad_heads_to > self.n_heads and \
                self.pad_heads_to % self.n_kv_heads:
            raise ValueError(
                f"pad_heads_to {self.pad_heads_to} is no multiple of n_kv_heads "
                f"{self.n_kv_heads}: each KV group pads to pad_heads_to // "
                f"n_kv_heads query heads")

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Kind of every layer, 0..n_layers-1 (pattern tiled + truncated)."""
        p = self.layer_pattern
        return (p * -(-self.n_layers // len(p)))[: self.n_layers]

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def d_rnn(self) -> int:
        if not self.rglru:
            return 0
        return self.rglru.d_rnn or self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """True when the pattern holds a bounded-cost mixer (local window,
        SSM, RG-LRU): such hybrids run ``long_500k``; pure full-attention
        archs (full-attention MoE too) skip it, as the reference's do."""
        return any(k in ("local", "mamba", "rglru") for k in self.layer_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), as the reference
        computes it."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """The same with each MoE layer's top_k experts only."""
        return _param_count(self, active_only=True)

    def smoke(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's reduction)."""
        period = len(self.layer_pattern)
        n_layers = period + 1 if self.n_layers > period else period
        kw = {}
        if self.moe:
            kw["moe"] = dataclasses.replace(self.moe, n_experts=8, d_expert=96)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=8)
        if self.rglru:
            kw["rglru"] = dataclasses.replace(self.rglru, d_rnn=64,
                                              block_width=32)
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
            n_prefix=min(self.n_prefix, 4),
            remat="none",
            **kw,
        )


def _param_count(cfg: ArchConfig, active_only: bool) -> int:
    M, V = cfg.d_model, cfg.vocab_size
    glu = 3 if cfg.mlp_glu else 2
    n = V * M if cfg.tie_embeddings else 2 * V * M
    for kind in cfg.layer_kinds:
        if kind in ATTN_KINDS:
            n += (M * cfg.n_heads * cfg.head_dim * 2        # q, o
                  + M * cfg.n_kv_heads * cfg.head_dim * 2)  # k, v
        if kind in ("dense", "local", "global"):
            n += M * cfg.d_ff * glu
        elif kind == "moe":
            m = cfg.moe
            e = m.top_k if active_only else m.n_experts
            n += e * M * m.d_expert * glu
            if m.shared_expert:
                n += M * m.d_expert * glu
            if m.dense_residual:
                n += M * cfg.d_ff * glu
            n += M * m.n_experts                          # router
        elif kind == "mamba":
            s = cfg.ssm
            di, dr = cfg.d_inner, s.resolved_dt_rank(M)
            n += (M * 2 * di                  # in_proj
                  + di * s.d_conv             # conv
                  + di * (dr + 2 * s.d_state)  # x_proj
                  + dr * di                   # dt_proj
                  + di * s.d_state + 2 * di   # A_log, D, dt bias-ish
                  + di * M)                   # out_proj
        elif kind == "rglru":
            dr = cfg.d_rnn
            n += (M * dr * 2                  # x, y branches in
                  + dr * cfg.rglru.d_conv
                  + 2 * dr * (cfg.rglru.block_width or dr)  # gates
                  + dr * M                    # out
                  + M * cfg.d_ff * glu)       # block MLP
        n += 2 * M                            # pre-norms (approx.)
    return n


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable, reason-if-not), the reference's rule and words."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k context skipped (DESIGN.md §5)"
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """Meta tensors standing in for every model input of this (arch,
    shape), the reference's keys, shapes and dtypes; no storage. Decode
    takes one new token a row, its caches built separately."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    specs: dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        specs["tokens"] = meta((B, S), torch.int32)
        specs["targets"] = meta((B, S), torch.int32)
        specs["loss_mask"] = meta((B, S), torch.float32)
    elif shape.kind == "prefill":
        specs["tokens"] = meta((B, S), torch.int32)
    else:
        specs["tokens"] = meta((B, 1), torch.int32)
        specs["pos"] = meta((B,), torch.int32)
    if cfg.n_prefix:
        specs["prefix_embed"] = meta((B, cfg.n_prefix, cfg.d_model),
                                     getattr(torch, cfg.compute_dtype))
    return specs


def flops_per_step(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE), D the tokens of
    the step; train counts forward and backward (6ND), prefill and decode
    the forward alone (2ND; decode one token a sequence)."""
    n = cfg.active_param_count() if cfg.moe else cfg.param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
