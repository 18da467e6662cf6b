"""How the reference takes its products.

``Exact``: float32 operands, float32 products, TF32 off (``exact()``
turns it off for the length of the reference's call and puts the flags
back as they were).

``FP8``: the control. The configuration serves bfloat16; the step below it
that would tempt a later change is fp8 products. Every weight product
takes its weight in float8 e4m3 with a scale per output column and its
input in float8 e4m3 with a scale per row, and multiplies the dequantized
values in float32: what an fp8 GEMM with row and column scales computes.
Everything else stays as in ``Exact``.
"""
from __future__ import annotations

import contextlib

import torch

E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact():
    """TF32 off for matmuls and cuDNN inside the block; the flags are put
    back on the way out."""
    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def fake_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one scale per slice along ``dim``'s
    complement (the amax over ``dim`` maps to 448), back in float32."""
    t = t.float()
    scale = t.abs().amax(dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(E4M3).float() * scale


class Exact:
    name = "float32"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return w.float()

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` with ``w`` already through ``weight``."""
        return self.act(x) @ w


class FP8(Exact):
    name = "fp8-e4m3"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return fake_fp8(w, 0)          # (in, out): a scale per output column

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fake_fp8(x, -1)         # a scale per row


PRECISIONS = {"float32": Exact, "fp8": FP8}
