"""Public wrapper: (B,S,H,D)-layout GQA attention, the port of
``repro/kernels/flash_attention/ops.py``.

A CUDA tensor goes to the hand-written kernel and a CPU tensor to the plain
version; nothing else chooses between them, and a failed build or launch
raises.

On the card the kernel runs inside an ``autograd.Function``. Its forward is
the kernel; its backward recomputes through the plain version and
differentiates that, one chunk of rows at a time
(``ref.attention_ref_vjp``). This is what the reference trains with: it has
no backward kernel and differentiates ``flash_attention_xla`` under
``jax.checkpoint`` ("flash backward = recompute"). The forward never gives
way to the plain version.
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
                  causal: bool = True, window: int = 0,
                  prefix: int = 0) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k/v: (B,Sk,Hkv,D). Returns (B,Sq,Hq,D). ``prefix``:
    every row also sees the keys k < prefix (the reference model's prefix-LM
    mask, which its Pallas kernel lacks); never with a window.

    Unlike the reference's wrapper, no block size has to divide Sq or Sk."""
    scale = scale or q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return gqa_attention_ref(q, k, v, scale=scale, softcap=softcap,
                                 causal=causal, window=window, prefix=prefix)
    return FlashAttention.apply(q, k, v, scale, softcap, causal, window,
                                prefix)


_OPTS = ("scale", "softcap", "causal", "window", "prefix")


class FlashAttention(torch.autograd.Function):
    """The kernel forward, the plain version's recomputed gradient backward.
    Saves q, k and v, not the output. ``apply(q, k, v, scale, softcap,
    causal, window[, prefix])``."""

    @staticmethod
    def forward(ctx, q, k, v, *opts):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(zip(_OPTS, opts))
        return kernel.flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        B = q.shape[0]
        dq, dk, dv = ref.attention_ref_vjp(
            _to_bh(q), _to_bh(k), _to_bh(v), _to_bh(do),
            groups=q.shape[2] // k.shape[2], **ctx.opts)
        return (_from_bh(dq, B), _from_bh(dk, B), _from_bh(dv, B),
                *(None,) * len(ctx.opts))


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: float = 0.0, softcap: float = 0.0,
                      causal: bool = True, window: int = 0,
                      prefix: int = 0) -> torch.Tensor:
    """The plain version, on any device."""
    B, Sq, Hq, D = q.shape
    groups = Hq // k.shape[2]
    scale = scale or D ** -0.5
    o = ref.attention_ref(_to_bh(q), _to_bh(k), _to_bh(v), groups=groups,
                          scale=scale, softcap=softcap, causal=causal,
                          window=window, prefix=prefix)
    return _from_bh(o, B)
