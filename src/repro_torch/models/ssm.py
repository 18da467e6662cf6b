"""Mamba-1 selective SSM block (falcon-mamba-7b), the port of
``repro/models/ssm.py``.

Prefill runs the scan through ``kernels.ssm_scan.ops.selective_scan`` (the
CUDA kernel on the card, its plain version on the CPU), where the reference
runs its chunked ``lax.scan``, whose Pallas drop-in is the TPU kernel. The
one-token decode step stays plain torch, as it stays XLA in the reference.

Under tensor parallelism (``tp``) ``inner`` is over ``model``: a rank holds
its channels of x and of z in ``in_proj``, of the conv, ``dt_proj``,
``A_log``, ``D`` and the state, and the scan kernel runs on them;
``x_proj`` and ``out_proj`` are row-parallel (dt, B and C are reduced in
f32 before they are split). What ``x_proj`` gives feeds this rank's
channels alone (``dt_proj``, the scan), so in training its gradient is
summed over ``model`` too: its all-reduce runs in both directions. The scan
runs through ``selective_scan``, on the card the kernel under
``SelectiveScan``, whose backward recomputes through the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.models.layers import ParamSpec, dense, row_dense

def mamba_specs(cfg) -> dict[str, ParamSpec]:
    s = cfg.ssm
    M, di, N = cfg.d_model, cfg.d_inner, s.d_state
    R = s.resolved_dt_rank(M)
    pdt = cfg.param_dtype
    return {
        "in_proj": ParamSpec((M, 2 * di), pdt, axes=("embed", "inner"),
                             parts=2),
        "conv_w": ParamSpec((s.d_conv, di), pdt, scale=1.0, axes=("conv", "inner")),
        "conv_b": ParamSpec((di,), pdt, init="zeros", axes=("inner",)),
        "x_proj": ParamSpec((di, R + 2 * N), pdt, axes=("inner", "dt")),
        "dt_proj": ParamSpec((R, di), pdt, axes=("dt", "inner")),
        "dt_bias": ParamSpec((di,), pdt, init="zeros", axes=("inner",)),
        # float32 whatever the param dtype, and used in float32
        # (A = -exp(A_log)): never cast to the compute dtype
        "A_log": ParamSpec((di, N), torch.float32, init="a_log",
                           keep_dtype=True, axes=("inner", "state")),
        "D": ParamSpec((di,), torch.float32, init="ones", keep_dtype=True,
                       axes=("inner",)),
        "out_proj": ParamSpec((di, M), pdt, axes=("inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along seq. x: (B,S,di); w: (K,di).
    carry: (B,K-1,di) previous inputs (decode) or None (zeros).
    Returns (y, new_carry). The reference's shifted sum, in x's dtype and in
    its order (not a cuDNN convolution, which would run f32 in TF32). The
    carry is a copy, so a cache does not hold the whole padded input."""
    B, S, di = x.shape
    K = w.shape[0]
    if carry is None:
        carry = x.new_zeros((B, K - 1, di))
    xp = torch.cat([carry.to(x.dtype), x], dim=1)     # (B, S+K-1, di)
    y = sum(xp[:, j:j + S] * w[j].to(x.dtype) for j in range(K))
    new_carry = xp[:, -(K - 1):].clone() if K > 1 else carry
    return y + b.to(x.dtype), new_carry


def mamba_block(params: dict, x: torch.Tensor, *, cfg,
                cache: Optional[dict] = None, return_cache: bool = False,
                tp=None):
    """x: (B,S,M). Returns (y, new_cache)."""
    B, S, _ = x.shape
    s = cfg.ssm
    di, N = params["D"].shape[0], s.d_state      # this rank's channels
    R = s.resolved_dt_rank(cfg.d_model)

    if tp is not None:
        x = tp.to_model(x)
    xi, z = dense(x, params["in_proj"]).split(di, dim=-1)
    conv_carry = cache["conv"] if cache is not None else None
    xi, new_conv = _causal_conv(xi, params["conv_w"], params["conv_b"],
                                conv_carry)
    xi = F.silu(xi)

    bcdt = row_dense(xi, params["x_proj"], tp, sublayer_out=False)
    if tp is not None:      # dt_r, B and C feed this rank's channels alone
        bcdt = tp.to_model(bcdt)
    dt_r, Bm, Cm = bcdt.split([R, N, N], dim=-1)
    # a compute-dtype product plus the f32 bias promotes to f32, as in JAX
    dt = F.softplus(dense(dt_r, params["dt_proj"]) + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())            # (di,N), negative

    if cache is not None:
        h0 = cache["h"]
    else:
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    if S == 1 and cache is not None:                   # decode fast path
        dt32 = dt[:, 0].float()
        decay = torch.exp(dt32[:, :, None] * A)
        inp = (dt32 * xi[:, 0].float())[:, :, None] * \
            Bm[:, 0].float()[:, None, :]
        h = decay * h0 + inp
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())[:, None]
        y = y.to(x.dtype)
    else:
        y, h = selective_scan(xi, dt, Bm, Cm, A, h0)

    y = y + params["D"].to(x.dtype) * xi
    y = y * F.silu(z)
    out = row_dense(y, params["out_proj"], tp)
    new_cache = {"conv": new_conv, "h": h} \
        if (cache is not None or return_cache) else None
    return out, new_cache
