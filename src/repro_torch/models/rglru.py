"""Griffin recurrent block with RG-LRU (recurrentgemma-9b), the port of
``repro/models/rglru.py``.

h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t),
a_t = exp(-c · softplus(Λ) · r_t),  c = 8.

The recurrence is diagonal. The reference computes it with
``jax.lax.associative_scan``, outside any Pallas kernel; here it is a
doubling (Hillis–Steele) scan in plain torch: ⌈log₂ S⌉ elementwise passes
over (B, S, d_rnn) in f32, where a loop over the sequence would launch a
few kernels a step. Its sums are taken in another order than JAX's, so the
two agree to f32 rounding, not bit for bit.

Under tensor parallelism (``tp``) ``rnn`` is over ``model``: a rank holds
its channels of ``w_x``, ``w_y``, the conv, the biases, ``lam`` and the
state, and its blocks of the block-diagonal gates (their blocks are its
channels); ``w_out`` is row-parallel. Between the two every product is on
the rank's own channels, so training needs no collective there.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, dense, row_dense
from repro_torch.models.ssm import _causal_conv

_C = 8.0


def rglru_specs(cfg) -> dict[str, ParamSpec]:
    M, dr = cfg.d_model, cfg.d_rnn
    bw = cfg.rglru.block_width or dr
    nb = dr // bw
    pdt = cfg.param_dtype
    return {
        "w_x": ParamSpec((M, dr), pdt, axes=("embed", "rnn")),
        "w_y": ParamSpec((M, dr), pdt, axes=("embed", "rnn")),
        "conv_w": ParamSpec((cfg.rglru.d_conv, dr), pdt, scale=1.0,
                            axes=("conv", "rnn")),
        "conv_b": ParamSpec((dr,), pdt, init="zeros", axes=("rnn",)),
        # block-diagonal input/recurrence gates; as in the reference, their
        # init's fan-in is the leading axis, the number of blocks
        "w_i": ParamSpec((nb, bw, bw), pdt, axes=("rnn", None, None)),
        "w_r": ParamSpec((nb, bw, bw), pdt, axes=("rnn", None, None)),
        "b_i": ParamSpec((dr,), pdt, init="zeros", axes=("rnn",)),
        "b_r": ParamSpec((dr,), pdt, init="zeros", axes=("rnn",)),
        "lam": ParamSpec((dr,), torch.float32, init="ones", keep_dtype=True,
                         axes=("rnn",)),
        "w_out": ParamSpec((dr, M), pdt, axes=("rnn", "embed")),
    }


def _block_diag(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B,S,dr); w: (nb,bw,bw) block-diagonal matmul, plus b."""
    B, S, dr = x.shape
    nb, bw, _ = w.shape
    y = torch.einsum("bsnw,nwv->bsnv", x.reshape(B, S, nb, bw), w.to(x.dtype))
    return y.reshape(B, S, dr) + b.to(x.dtype)


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Diagonal linear recurrence h_t = a_t*h_{t-1} + b_t. a, b: (B,S,dr)
    f32; h0: (B,dr). Returns (h_all (B,S,dr), h_last).

    h0 is folded into the first element (b_0 + a_0 h0, as the reference
    does); then each pass d = 1, 2, 4, ... combines element t with element
    t - d: (a_{t-d}, b_{t-d}) then (a_t, b_t) is (a_t a_{t-d},
    a_t b_{t-d} + b_t). Each pass makes new tensors, so autograd can
    differentiate it."""
    S = a.shape[1]
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:   # the last pass needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b, b[:, -1]


def rglru_block(params: dict, x: torch.Tensor, *, cfg,
                cache: Optional[dict] = None, return_cache: bool = False,
                tp=None):
    """Griffin recurrent mixer. x: (B,S,M). Returns (y, new_cache): with a
    cache and S == 1 one decode step, else the scan over the sequence."""
    B, S, _ = x.shape
    dr = params["lam"].shape[0]           # this rank's channels
    if tp is not None:
        x = tp.to_model(x)

    y_branch = F.gelu(dense(x, params["w_y"]), approximate="tanh")
    xb = dense(x, params["w_x"])
    conv_carry = cache["conv"] if cache is not None else None
    xb, new_conv = _causal_conv(xb, params["conv_w"], params["conv_b"],
                                conv_carry)

    gate_i = torch.sigmoid(_block_diag(xb, params["w_i"], params["b_i"]))
    gate_r = torch.sigmoid(_block_diag(xb, params["w_r"], params["b_r"]))
    log_a = (-_C * F.softplus(params["lam"].float())) * gate_r.float()
    a = torch.exp(log_a)
    # sqrt(1-a^2) computed in log space for stability near a -> 1
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated_x = beta * (gate_i.float() * xb.float())

    if cache is not None:
        h0 = cache["h"]
    else:
        h0 = torch.zeros((B, dr), dtype=torch.float32, device=x.device)
    if S == 1 and cache is not None:
        h_last = a[:, 0] * h0 + gated_x[:, 0]
        h = h_last[:, None]
    else:
        h, h_last = rglru_scan(a, gated_x, h0)

    out = row_dense(h.to(x.dtype) * y_branch, params["w_out"], tp)
    new_cache = ({"conv": new_conv, "h": h_last}
                 if (cache is not None or return_cache) else None)
    return out, new_cache
