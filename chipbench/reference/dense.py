"""A dense decoder layer as Qwen2 publishes it (arXiv:2407.10671, the
Hugging Face ``Qwen2DecoderLayer``): pre-norm RMSNorm, grouped-query
attention with a bias on the q, k and v projections, rotary embeddings
(``rope_theta``), a SwiGLU MLP, and the two residual adds.

Causal attention is taken in blocks of query rows, each against the keys
up to its last row, so a 32k prompt fits; the MLP in blocks of tokens.
Rotary angles are taken in float64 and rounded once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chipbench.reference.model import rms_norm

ATTN_ROWS = 512        # query rows a block of causal attention
MLP_ROWS = 8192        # tokens a block of the MLP


def dims(c: dict) -> dict:
    M, Hq, Hkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    D = c.get("head_dim") or M // Hq
    return {"M": M, "Hq": Hq, "Hkv": Hkv, "D": D, "F": c["intermediate_size"]}


def weights(c: dict) -> dict:
    """One layer's weights: name -> (shape, dtype, init). Matrices are
    (in, out), served in bfloat16; norm scales and biases float32."""
    d = dims(c)
    M, Hq, Hkv, D, Fw = d["M"], d["Hq"], d["Hkv"], d["D"], d["F"]
    w = {
        "input_layernorm": ((M,), "float32", ("jitter", 0.1)),
        "q_proj": ((M, Hq * D), "bfloat16", ("normal", M ** -0.5)),
        "k_proj": ((M, Hkv * D), "bfloat16", ("normal", M ** -0.5)),
        "v_proj": ((M, Hkv * D), "bfloat16", ("normal", M ** -0.5)),
        "o_proj": ((Hq * D, M), "bfloat16", ("normal", (Hq * D) ** -0.5)),
        "post_attention_layernorm": ((M,), "float32", ("jitter", 0.1)),
        "gate_proj": ((M, Fw), "bfloat16", ("normal", M ** -0.5)),
        "up_proj": ((M, Fw), "bfloat16", ("normal", M ** -0.5)),
        "down_proj": ((Fw, M), "bfloat16", ("normal", Fw ** -0.5)),
    }
    if c.get("attention_bias", False):
        for n, width in (("q_bias", Hq * D), ("k_bias", Hkv * D),
                         ("v_bias", Hkv * D)):
            w[n] = ((width,), "float32", ("normal", 0.5))
    return w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) at positions 0..S-1; the halves rotated
    (``rotate_half``), angles pos * theta^(-2i/D) in float64."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().float()[None, :, None, :]
    sin = ang.sin().float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D); every row sees the keys up
    to its own position. Returns (B, S, Hq, D)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    out = torch.empty_like(q)
    for i0 in range(0, S, ATTN_ROWS):
        i1 = min(S, i0 + ATTN_ROWS)
        s = torch.einsum("blhgd,bthd->bhglt", qg[:, i0:i1], k[:, :i1]) * scale
        rows = torch.arange(i0, i1, device=q.device)[:, None]
        cols = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhglt,bthd->blhgd", p, v[:, :i1])
        out[:, i0:i1] = o.reshape(B, i1 - i0, Hq, D)
        del s, p, o
    return out


def layer(c: dict, w: dict, x: torch.Tensor, prec) -> torch.Tensor:
    """One layer on x (B, S, M) float32 at positions 0..S-1; ``w`` this
    layer's weights already through ``prec.weight`` (matrices) and
    ``float`` (vectors)."""
    d = dims(c)
    B, S, M = x.shape
    Hq, Hkv, D = d["Hq"], d["Hkv"], d["D"]
    eps = c["rms_norm_eps"]
    h = rms_norm(x, w["input_layernorm"], eps)
    q, k, v = (prec.mm(h, w[n]) for n in ("q_proj", "k_proj", "v_proj"))
    if "q_bias" in w:
        q, k, v = q + w["q_bias"], k + w["k_bias"], v + w["v_bias"]
    del h
    theta = float(c["rope_theta"])
    q = rope(q.reshape(B, S, Hq, D), theta)
    k = rope(k.reshape(B, S, Hkv, D), theta)
    o = causal_attention(q, k, v.reshape(B, S, Hkv, D), 1.0 / math.sqrt(D))
    del q, k, v
    x = x + prec.mm(o.reshape(B, S, Hq * D), w["o_proj"])
    del o
    for s0 in range(0, S, MLP_ROWS):
        xs = x[:, s0:s0 + MLP_ROWS]
        h = rms_norm(xs, w["post_attention_layernorm"], eps)
        a = F.silu(prec.mm(h, w["gate_proj"])) * prec.mm(h, w["up_proj"])
        xs += prec.mm(a, w["down_proj"])
        del h, a
    return x
