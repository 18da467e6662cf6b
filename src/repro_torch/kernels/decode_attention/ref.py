"""The plain version of one-token decode attention, the port of the
reference's ``decode_attention_xla`` (``repro/models/attention.py``; the
reference has no kernel for it), and the pieces the CUDA kernel shares with
it: the per-row slot bound and the combine of a sequence-sharded cache's
partials.

q: (B, 1, Hq, D); caches: (B, T, Hkv, D); pos: (B,) position of the new
token; cache_positions: (B, T) position held by each slot, < 0 when empty.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def slot_bound(pos: torch.Tensor, T: int, seq_index: int = 0) -> torch.Tensor:
    """(B,) int64: n_b, the kernel's bound on the slots row b reads, [0,
    n_b) = clamp(pos + 1 - seq_index·T, 0, T).

    Exact for every cache the program writes: ``cache_insert`` puts position
    p at slot p % T, or at p % (T·n) - index·T on rank ``index`` of a cache
    whose slots are split over n ranks (``seq``), and ``cache_from_prefill``
    puts prefill position t (0, 1, ...) at slot t, or at t % window in a
    ring. So a slot at or past n_b is empty or holds a position past pos,
    which the mask drops."""
    return (pos.long() + 1 - seq_index * T).clamp(0, T)


def _masked_scores(q, k_cache, *, pos, cache_positions, scale, cap, window):
    """(B, Hkv, G, T) f32 scores x scale, softcapped, NEG_INF where the slot
    is empty, past pos or outside the window."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bthd->bhgt", qg.float(), k_cache.float())
    s = s * scale
    s = torch.tanh(s / cap) * cap if cap else s
    valid = (cache_positions >= 0) & (cache_positions <= pos[:, None])
    if window:
        valid &= (pos[:, None] - cache_positions) < window
    return torch.where(valid[:, None, None, :], s, NEG_INF)


def _partial(s: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    return torch.cat([m, p.sum(-1, keepdim=True),
                      torch.einsum("bhgt,bthd->bhgd", p, v_cache.float())], -1)


def decode_partial(q, k_cache, v_cache, *, pos, cache_positions, scale: float,
                   cap: float, window: int = 0) -> torch.Tensor:
    """(B, Hkv, G, D + 2) f32: this cache's (max m, sum l, unnormalised
    output o) over its slots. A cache none of whose slots is valid gives m =
    NEG_INF, which the combine weighs by e^(NEG_INF - M) = 0."""
    return _partial(_masked_scores(q, k_cache, pos=pos,
                                   cache_positions=cache_positions,
                                   scale=scale, cap=cap, window=window), v_cache)


def combine(parts: list[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The ranks' partials (each (B, Hkv, G, D + 2)), combined alike on every
    rank: out = sum_i e^(m_i - M) o_i / sum_i e^(m_i - M) l_i, M the largest
    m_i. Returns (B, 1, Hq, D) in ``dtype``."""
    parts = torch.stack(parts)                           # (n, B, Hkv, G, D+2)
    m_all, l_all, o_all = parts[..., :1], parts[..., 1:2], parts[..., 2:]
    w = torch.exp(m_all - m_all.amax(0))
    o = (w * o_all).sum(0) / (w * l_all).sum(0).clamp_min(1e-30)
    B, Hkv, G, D = o.shape
    return o.to(dtype).reshape(B, 1, Hkv * G, D)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: torch.Tensor,
                     cache_positions: torch.Tensor, scale: float, cap: float,
                     window: int = 0, group=None) -> torch.Tensor:
    """One-token decode over every slot of the cache, on any device.
    Returns (B, 1, Hq, D).

    With ``group`` (an ``AxisGroup``) the cache's slots are split across its
    ranks and this rank holds ``k_cache``'s share: each rank's f32 partial
    (``decode_partial``) is gathered and every rank combines them alike
    (``combine``)."""
    B, _, Hq, D = q.shape
    s = _masked_scores(q, k_cache, pos=pos, cache_positions=cache_positions,
                       scale=scale, cap=cap, window=window)
    if group is None:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype), v_cache)
        return o.reshape(B, 1, Hq, D)
    return combine(group.all_gather(_partial(s, v_cache)), v_cache.dtype)
