"""Mixture-of-Experts with capacity-based top-k dispatch (llama4 / arctic),
the port of ``repro/models/moe.py``.

GShard-style grouped dispatch, as the reference computes it: tokens grouped
by sequence (prefill, training) or into a single group (decode), routed in
f32, each token's top-k experts given a 1-based position in the expert's
queue by an in-group cumsum in token-major order, slots past the capacity
dropped (a dropped token reaches the output through the residual only),
a gather to a dense (G, E, C, M) tensor, the expert products, and an f32
scatter-add combine. The reference computes the expert products outside
any Pallas kernel (XLA's einsum), so here they are ``torch.einsum``.

Expert parallelism (``tp``): the experts are over ``model``. The router's
expert columns are too; its f32 logits are gathered over ``model`` before
top-k, so every rank routes alike. A rank runs its own experts on their
slots and scatters its share in f32; the shares are summed over ``model``
and rounded once. The shared and dense MLPs are tensor-parallel. Decode
routes the whole batch as one group, as the reference does, so where the
batch rows are split over DP the tokens are gathered first.

In training the router and the experts take their input through
``tp.to_model``, the gathered router logits give each rank its slice of
their gradient, and the routing weights pass through ``tp.to_model`` once
more: a rank's experts give the gradient of their own slots' weights alone,
which are summed over ``model`` before the softmax, while the aux losses,
the same on every rank, count once. With ``fsdp_experts`` (``tp.fsdp``)
each expert weight is sharded over ``data`` on its ffn axis and gathered
whole where the layer runs; its gradient is summed over ``data`` and cut
back to the rank's share.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ACTS, ParamSpec, mlp, mlp_specs


def moe_specs(cfg) -> dict:
    m = cfg.moe
    M, E, Fe = cfg.d_model, m.n_experts, m.d_expert
    pdt = cfg.param_dtype
    specs: dict = {
        # routing is f32 whatever the param dtype (the reference declares
        # the router f32 and routes in f32): a bf16 router would flip
        # near-tie routings, so it is never cast to the compute dtype
        "router": ParamSpec((M, E), torch.float32, keep_dtype=True,
                            axes=("embed", "expert")),
        "wi": ParamSpec((E, M, Fe), pdt, axes=("expert", "embed", "expert_ffn")),
        "wo": ParamSpec((E, Fe, M), pdt, axes=("expert", "expert_ffn", "embed")),
    }
    if cfg.mlp_glu:
        specs["wg"] = ParamSpec((E, M, Fe), pdt,
                                axes=("expert", "embed", "expert_ffn"))
    if m.shared_expert:
        specs["shared"] = mlp_specs(M, Fe, cfg.mlp_glu, pdt)
    if m.dense_residual:
        specs["dense"] = mlp_specs(M, cfg.d_ff, cfg.mlp_glu, pdt)
    return specs


def capacity(T: int, k: int, E: int, factor: float) -> int:
    """Slots an expert has in a group of T tokens."""
    return max(1, math.ceil(T * k / E * factor))


def route(router: torch.Tensor, xg: torch.Tensor, *, top_k: int,
          capacity_factor: float, tp=None) -> dict:
    """Routing and the dispatch plan of tokens xg (G, T, M), in f32.

    Returns the router ``logits`` and ``probs`` (G, T, E); ``onehot``
    (G, T*k, E), each token's k choices in token-major order; the capacity
    ``C``; ``token_for_slot`` (G, E*C), the token each expert slot takes
    (0 where the slot is empty); ``w_for_slot`` (G, E*C), its renormalised
    top-k weight (0 where empty); and ``dropped`` (G,), the choices past
    their expert's capacity in each group. Under ``tp`` ``router`` holds
    this rank's experts and the logits are gathered over ``model``."""
    G, T, _ = xg.shape
    logits = xg.float() @ router.float()
    if tp is not None:
        logits = tp.gather(logits)
    E, k = logits.shape[-1], top_k
    C = capacity(T, k, E, capacity_factor)
    probs = torch.softmax(logits, dim=-1)
    # each rank's experts weigh their own slots alone: the weights'
    # gradient is summed over model (the aux losses read probs, once)
    top_p, top_e = torch.topk(probs if tp is None else tp.to_model(probs),
                              k, dim=-1)                          # (G,T,k)
    top_w = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = top_e.reshape(G, T * k)
    oh = F.one_hot(flat_e, E)                                     # (G,Tk,E)
    pos = (oh.cumsum(dim=1) * oh).sum(-1)                         # 1-based
    keep = (pos >= 1) & (pos <= C)
    # slot E*C is the drop slot: a spare column, cut off below
    slot = torch.where(keep, flat_e * C + (pos - 1), E * C)
    tok = torch.arange(T, device=xg.device).repeat_interleave(k)
    token_for_slot = torch.zeros((G, E * C + 1), dtype=torch.long,
                                 device=xg.device)
    token_for_slot.scatter_(1, slot, tok.expand(G, T * k))
    w_for_slot = torch.zeros((G, E * C + 1), dtype=torch.float32,
                             device=xg.device)
    w_for_slot.scatter_(1, slot, top_w.reshape(G, T * k))
    return {"logits": logits, "probs": probs, "onehot": oh, "C": C,
            "token_for_slot": token_for_slot[:, :E * C],
            "w_for_slot": w_for_slot[:, :E * C],
            "dropped": (~keep).sum(-1)}


def moe_block(params: dict, x: torch.Tensor, *, cfg, tp=None):
    """x: (B,S,M). Returns (y, aux losses {"moe_lb", "moe_z"} as f32
    scalars)."""
    m = cfg.moe
    B, S, M = x.shape
    E, k = m.n_experts, m.top_k
    rows = None
    if S == 1 and tp is not None and tp.dp is not None:
        # decode routes the global batch as one group: every DP rank's rows
        rows = slice(tp.dp.index * B, (tp.dp.index + 1) * B)
        x_all = tp.gather(x, tp.dp, dim=0)
    else:
        x_all = x
    if tp is not None:
        x_all = tp.to_model(x_all)
    xg = x_all.reshape(1, -1, M) if S == 1 else x_all  # decode: one group
    G, T, _ = xg.shape
    plan = route(params["router"], xg, top_k=k,
                 capacity_factor=m.capacity_factor, tp=tp)
    C = plan["C"]
    # this rank's experts and their slots (all of them without tp)
    wi, wo, wg = params["wi"], params["wo"], params.get("wg")
    if tp is not None:
        wi, wo = tp.fsdp_gather(wi, 2), tp.fsdp_gather(wo, 1)
        wg = None if wg is None else tp.fsdp_gather(wg, 2)
    E_local = wi.shape[0]
    e_lo = tp.r * E_local if tp is not None else 0
    mine = slice(e_lo * C, (e_lo + E_local) * C)
    token_for_slot = plan["token_for_slot"][:, mine]

    # expert compute
    g_idx = torch.arange(G, device=x.device)[:, None]
    xe = xg[g_idx, token_for_slot].reshape(G, E_local, C, M)
    h = torch.einsum("gecm,emf->gecf", xe, wi.to(xe.dtype))
    a = ACTS[cfg.mlp_act](h)
    if wg is not None:
        a = a * torch.einsum("gecm,emf->gecf", xe, wg.to(xe.dtype))
    ye = torch.einsum("gecf,efm->gecm", a, wo.to(xe.dtype))

    # combine: an f32 scatter-add, dropped and empty slots carrying weight 0
    contrib = (plan["w_for_slot"][:, mine][..., None]
               * ye.reshape(G, E_local * C, M).float())
    dest = (g_idx * T + token_for_slot).reshape(-1)
    y = torch.zeros((G * T, M), dtype=torch.float32, device=x.device)
    y = y.index_add(0, dest, contrib.reshape(G * E_local * C, M))
    y = (y.to(x.dtype) if tp is None or tp.m == 1
         else tp.reduce(y, x.dtype, sublayer_out=True))
    y = y.reshape(-1, S, M)
    if rows is not None:
        y = y[rows]

    # always-on paths
    if "shared" in params:
        y = y + mlp(params["shared"], x, cfg.mlp_act, tp)
    if "dense" in params:
        y = y + mlp(params["dense"], x, cfg.mlp_act, tp)

    # aux losses
    frac_tokens = plan["onehot"].float().mean(dim=(0, 1)) * k       # (E,)
    if S > 1 and tp is not None and tp.dp is not None:
        # the reference's fractions are the global batch's: with the rows
        # split over DP, each rank weighs its own mean probabilities by
        # them, and the DP mean of its lb is the global batch's lb, its
        # gradient each rank's share of that lb's
        frac_tokens = tp.dp.all_reduce_sum(frac_tokens.clone()) / tp.dp.size
    mean_prob = plan["probs"].mean(dim=(0, 1))
    lb = E * (frac_tokens * mean_prob).sum() / k
    zl = torch.logsumexp(plan["logits"], dim=-1).square().mean()
    return y, {"moe_lb": lb, "moe_z": zl}
