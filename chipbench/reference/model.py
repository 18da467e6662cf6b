"""What every configuration has around its layers: the token embedding,
the final RMSNorm and the output head (untied), and the run of the layers
in order, each by its block kind's module (``chipbench/reference/<kind>.py``).

The weights are the raw tensors of ``chipbench.weights``: the layers' as
one stacked tensor a name and kind, taken one layer at a time and turned
into float32 (the products' through the precision's ``weight``) only
while that layer runs, so that a float32 copy of the whole model is never
held.
"""
from __future__ import annotations

import importlib

import torch

from chipbench.reference import precision


def block(kind: str):
    return importlib.import_module(f"chipbench.reference.{kind}")


def layer_kinds(c: dict) -> list[str]:
    return list(c.get("layer_types") or [c["block"]] * c["num_hidden_layers"])


def norm_eps(c: dict) -> float:
    return c.get("rms_norm_eps", c.get("layer_norm_epsilon"))


def model_weights(c: dict) -> dict:
    """The weights outside the layers: name -> (shape, dtype, init)."""
    M, V = c["hidden_size"], c["vocab_size"]
    return {"embed_tokens": ((V, M), "bfloat16", ("normal", 1.0)),
            "norm": ((M,), "float32", ("jitter", 0.1)),
            "lm_head": ((M, V), "bfloat16", ("normal", M ** -0.5))}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def is_product(name: str) -> bool:
    """A weight that enters a product (a GEMM), which the control takes in
    its lower precision; every other weight is taken in float32."""
    return name.endswith("_proj") or name == "lm_head"


class Reference:
    """The forward pass of configuration ``c`` over ``weights`` in the
    precision ``prec`` ("float32" or "fp8"). Call inside
    ``precision.exact()``."""

    def __init__(self, c: dict, weights: dict, prec: str = "float32"):
        self.c, self.w = c, weights
        self.prec = precision.PRECISIONS[prec]()
        self._head = None

    def _layer_weights(self, kind: str, i: int) -> dict:
        return {n: (self.prec.weight(t[i]) if is_product(n) else t[i].float())
                for n, t in self.w["layers"][kind].items()}

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> the final-normed hidden states (B, S, M)."""
        x = self.w["model"]["embed_tokens"][tokens].float()
        seen: dict[str, int] = {}
        for kind in layer_kinds(self.c):
            i = seen.get(kind, 0)
            seen[kind] = i + 1
            x = block(kind).layer(self.c, self._layer_weights(kind, i), x,
                                  self.prec)
        return rms_norm(x, self.w["model"]["norm"], norm_eps(self.c))

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Hidden states (..., M) -> logits (..., V) in float32."""
        if self._head is None:
            self._head = self.prec.weight(self.w["model"]["lm_head"])
        return self.prec.mm(h, self._head)
