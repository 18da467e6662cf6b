"""A Mamba-1 layer (arXiv:2312.00752; the mixer of falcon-mamba-7b,
arXiv:2410.05355): pre-norm RMSNorm, the input projection into x and the
gate z, a depthwise causal convolution over time with a bias, SiLU, the
projection of x into (dt, B, C), dt through its projection, bias and
softplus, the selective scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,
y_t = C_t . h_t + D x_t, the gate SiLU(z), the output projection and the
residual add. A = -exp(A_log).

FalconMamba (the Hugging Face ``FalconMambaMixer``) adds parameter-free
RMS norms on dt's low-rank input, B and C, each over its own width, at
``mixer_rms_eps``; a configuration that states that key gets them, one
that does not (Mamba-1's own) does not. The whole layer is taken in
float32, the residual with it.

The scan is taken in float32 as a parallel linear recurrence: pairs of
steps are combined, the half-length recurrence solved, the even steps
filled in. It differs from the sequential loop by rounding alone.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chipbench.reference.model import rms_norm

SCAN_CHANNELS = 1024    # channels a block of the scan


def dims(c: dict) -> dict:
    M = c["hidden_size"]
    di = c["expand"] * M
    return {"M": M, "di": di, "N": c["state_size"], "K": c["conv_kernel"],
            "R": c.get("time_step_rank") or math.ceil(M / 16)}


def weights(c: dict) -> dict:
    """One layer's weights: name -> (shape, dtype, init). Matrices are
    (in, out), served in bfloat16; vectors, A_log and D float32."""
    d = dims(c)
    M, di, N, K, R = d["M"], d["di"], d["N"], d["K"], d["R"]
    return {
        "norm": ((M,), "float32", ("jitter", 0.1)),
        "in_proj": ((M, 2 * di), "bfloat16", ("normal", M ** -0.5)),
        "conv_w": ((K, di), "bfloat16", ("normal", K ** -0.5)),
        "conv_b": ((di,), "float32", ("normal", 0.1)),
        "x_proj": ((di, R + 2 * N), "bfloat16", ("normal", di ** -0.5)),
        "dt_proj": ((R, di), "bfloat16", ("normal", R ** -0.5)),
        "dt_bias": ((di,), "float32", ("dt_bias", 1e-3, 1e-1)),
        "A_log": ((di, N), "float32", ("a_log",)),
        "D": ((di,), "float32", ("ones",)),
        "out_proj": ((di, M), "bfloat16", ("normal", di ** -0.5)),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over time: y_t = b + sum_j w[j] x_{t-K+1+j}.
    x: (B, S, di); w: (K, di)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = b.expand_as(x).clone()
    for j in range(K):
        y += xp[:, j:j + S] * w[j]
    return y


def linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 0, from h_{-1} = 0."""
    T = a.shape[0]
    if T == 1:
        return b.clone()
    if T % 2:
        a = torch.cat([a, torch.ones_like(a[:1])])
        b = torch.cat([b, torch.zeros_like(b[:1])])
    a0, a1, b0 = a[0::2], a[1::2], b[0::2]
    h_odd = linear_recurrence(a1 * a0, a1 * b0 + b[1::2])
    h_even = b0.clone()
    h_even[1:] += a0[1:] * h_odd[:-1]
    return torch.stack([h_even, h_odd], 1).flatten(0, 1)[:T]


def selective_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """x, dt: (B, S, di); Bm, Cm: (B, S, N); A: (di, N); from a zero
    state. Returns y (B, S, di) = C_t . h_t."""
    Bsz, S, di = x.shape
    y = torch.empty_like(x)
    for r in range(Bsz):
        for d0 in range(0, di, SCAN_CHANNELS):
            d1 = min(di, d0 + SCAN_CHANNELS)
            dtc = dt[r, :, d0:d1]
            a = torch.exp(dtc[..., None] * A[d0:d1])
            u = (dtc * x[r, :, d0:d1])[..., None] * Bm[r, :, None, :]
            h = linear_recurrence(a, u)
            del a, u
            y[r, :, d0:d1] = (h * Cm[r, :, None, :]).sum(-1)
            del h
    return y


def layer(c: dict, w: dict, x: torch.Tensor, prec) -> torch.Tensor:
    """One layer on x (B, S, M) float32; ``w`` this layer's weights already
    through ``prec.weight`` (matrices) and ``float`` (the rest)."""
    d = dims(c)
    di, N, R = d["di"], d["N"], d["R"]
    h = rms_norm(x, w["norm"], c["layer_norm_epsilon"])
    xz = prec.mm(h, w["in_proj"])
    del h
    xi, z = xz[..., :di], xz[..., di:]
    xi = F.silu(causal_conv(xi, w["conv_w"], w["conv_b"]))
    dbc = prec.mm(xi, w["x_proj"])
    dtr, Bm, Cm = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    eps = c.get("mixer_rms_eps")
    if eps is not None:
        dtr, Bm, Cm = (t * torch.rsqrt(t.square().mean(-1, keepdim=True) + eps)
                       for t in (dtr, Bm, Cm))
    dt = F.softplus(prec.mm(dtr.contiguous(), w["dt_proj"]) + w["dt_bias"])
    y = selective_scan(xi, dt, Bm, Cm, -torch.exp(w["A_log"]))
    del dt, dbc
    y = (y + w["D"] * xi) * F.silu(z)
    del xz, xi, z
    return x + prec.mm(y, w["out_proj"])
