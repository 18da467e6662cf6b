"""Public wrapper: (B,S,H,D)-layout GQA attention, the port of
``repro/kernels/flash_attention/ops.py``.

A CUDA tensor goes to the hand-written kernel and a CPU tensor to the plain
version; nothing else chooses between them, and a failed build or launch
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def _to_bh(x: torch.Tensor) -> torch.Tensor:  # (B,S,H,D) -> (B*H, S, D)
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D)


def _from_bh(x: torch.Tensor, B: int) -> torch.Tensor:
    BH, S, D = x.shape
    return x.reshape(B, BH // B, S, D).transpose(1, 2)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float = 0.0, softcap: float = 0.0,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k/v: (B,Sk,Hkv,D). Returns (B,Sq,Hq,D).

    Unlike the reference's wrapper, no block size has to divide Sq or Sk."""
    scale = scale or q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return gqa_attention_ref(q, k, v, scale=scale, softcap=softcap,
                                 causal=causal, window=window)
    return kernel.flash_attention(q, k, v, scale=scale, softcap=softcap,
                                  causal=causal, window=window)


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: float = 0.0, softcap: float = 0.0,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """The plain version, on any device."""
    B, Sq, Hq, D = q.shape
    groups = Hq // k.shape[2]
    scale = scale or D ** -0.5
    o = ref.attention_ref(_to_bh(q), _to_bh(k), _to_bh(v), groups=groups,
                          scale=scale, softcap=softcap, causal=causal,
                          window=window)
    return _from_bh(o, B)
