"""Multi-channel fusion, in plain torch (port of
``a_modular_rag_framework_tpu/ops/fusion.py``).

Per-channel min-max over each channel's own pool (degenerate pools
normalize to 0), alpha-weighted sum over the union of the pools, final
top-k; optionally the k hits are re-ranked by a second weighting.

- `fuse_pools_compact`: over the union of the text and graph pools
  (sort-dedup on the key ``id*2 + flag``, text first), no [B, N] buffer;
- `fuse_channels`: the dense [..., C, N] oracle over presence masks.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .topk import stable_topk

NEG_INF = -1e30


def minmax_normalize(scores: torch.Tensor, present: torch.Tensor
                     ) -> torch.Tensor:
    """Min-max over the present entries of the last dim; all 0 where the
    pool is degenerate."""
    vmin = torch.amin(torch.where(present, scores, torch.full_like(scores, 1e30)),
                      dim=-1, keepdim=True)
    vmax = torch.amax(torch.where(present, scores,
                                  torch.full_like(scores, -1e30)),
                      dim=-1, keepdim=True)
    span = vmax - vmin
    ok = span > 0
    normed = torch.where(present, (scores - vmin) / torch.where(
        ok, span, torch.ones_like(span)), torch.zeros_like(scores))
    return torch.where(ok, normed, torch.zeros_like(scores))


def fuse_channels(
    channel_scores: torch.Tensor,  # [..., C, N] f32
    channel_present: torch.Tensor,  # [..., C, N] bool
    alphas: torch.Tensor,  # [C] f32
    *,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(top scores [..., k], top ids int32 [..., k], normalized
    [..., C, N]); slots past the union's size carry id -1 and score 0."""
    normed = minmax_normalize(channel_scores, channel_present)
    fused = torch.einsum("c,...cn->...n", alphas, normed)
    union = torch.any(channel_present, dim=-2)
    masked = torch.where(union, fused, torch.full_like(fused, NEG_INF))
    top_s, top_i = stable_topk(masked, k, dim=-1)
    valid = top_s > NEG_INF / 2
    return (torch.where(valid, top_s, torch.zeros_like(top_s)),
            torch.where(valid, top_i, -1).to(torch.int32), normed)


# the row-wise form JAX vmaps is the same function over the last dim
minmax_rows = minmax_normalize


def reorder_hits(top_s: torch.Tensor, top_i: torch.Tensor,
                 norms_at: torch.Tensor,
                 order_alphas: Sequence[float],
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Re-rank selected hits by ``order_alphas`` over their channel norms.

    Returns the permuted (ordering scores, ids, norms [B, 3, k]); padding
    hits (id -1) sink to the end. One stable sort of k keys."""
    a_t, a_g, a_d = (float(a) for a in order_alphas)
    order_s = norms_at[:, 0] * a_t + norms_at[:, 1] * a_g + norms_at[:, 2] * a_d
    ok = top_i >= 0
    key = torch.where(ok, -order_s, torch.full_like(order_s, -NEG_INF))
    perm = torch.sort(key, dim=1, stable=True).indices
    order_out = torch.gather(torch.where(ok, order_s,
                                         torch.zeros_like(order_s)), 1, perm)
    ids_out = torch.gather(top_i, 1, perm)
    norms_out = torch.gather(norms_at, 2,
                             perm[:, None, :].expand_as(norms_at))
    return order_out, ids_out, norms_out


def fuse_pools_compact(
    pool_s: torch.Tensor,  # [B, P] f32 text-pool scores (exact BM25)
    pool_i: torch.Tensor,  # [B, P] int32 text-pool global ids
    pool_valid: torch.Tensor,  # [B, P] bool
    dense_pool: torch.Tensor,  # [B, P] f32 cosine at text-pool ids
    t_graph_raw: torch.Tensor,  # [B, P] f32 raw graph score at text-pool ids
    g_pool_s: torch.Tensor,  # [B, G] f32 graph-pool scores
    g_pool_i: torch.Tensor,  # [B, G] int32 graph-pool global ids
    g_valid: torch.Tensor,  # [B, G] bool
    *,
    alphas: torch.Tensor,  # [3] f32 (text, graph, dense)
    k: int,
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(top_s [B, k], top_i int32 [B, k] -1 padded, norms_at [B, 3, k])."""
    nt = minmax_rows(pool_s, pool_valid)
    nd = minmax_rows(dense_pool, pool_valid)
    ng_pool = minmax_rows(g_pool_s, g_valid)
    # graph values at text-pool ids, normalized against the graph pool's
    # min-max iff the id is a graph-pool member (>= the pool's min score)
    g_lo = torch.amin(torch.where(g_valid, g_pool_s,
                                  torch.full_like(g_pool_s, 1e30)),
                      dim=1, keepdim=True)
    g_hi = torch.amax(torch.where(g_valid, g_pool_s,
                                  torch.full_like(g_pool_s, -1e30)),
                      dim=1, keepdim=True)
    g_span = g_hi - g_lo
    g_span_ok = g_span > 0
    in_gpool = pool_valid & (t_graph_raw > 0) & (t_graph_raw >= g_lo)
    ng_text = torch.where(
        in_gpool & g_span_ok,
        (t_graph_raw - g_lo) / torch.where(g_span_ok, g_span,
                                           torch.ones_like(g_span)),
        torch.zeros_like(t_graph_raw))

    fused_text = alphas[0] * nt + alphas[1] * ng_text + alphas[2] * nd
    fused_g = alphas[1] * ng_pool

    # union with dedup: sort by (id, text first); a duplicate id is always
    # a text + graph pair, and the text entry wins
    ids_cat = torch.cat([pool_i, g_pool_i], dim=1).to(torch.int32)
    flag = torch.cat([torch.zeros_like(pool_i, dtype=torch.int32),
                      torch.ones_like(g_pool_i, dtype=torch.int32)], dim=1)
    valid_cat = torch.cat([pool_valid, g_valid], dim=1)
    fused_cat = torch.cat([fused_text, fused_g], dim=1)
    nt_cat = torch.cat([nt, torch.zeros_like(ng_pool)], dim=1)
    ng_cat = torch.cat([ng_text, ng_pool], dim=1)
    nd_cat = torch.cat([nd, torch.zeros_like(ng_pool)], dim=1)

    sort_ids = torch.where(valid_cat, ids_cat,
                           torch.full_like(ids_cat, n + 1))
    key = sort_ids * 2 + flag  # unique per row: (id, flag) pairs are distinct
    key_s, order = torch.sort(key, dim=1, stable=True)
    fused_s = torch.gather(fused_cat, 1, order)
    nt_s = torch.gather(nt_cat, 1, order)
    ng_s = torch.gather(ng_cat, 1, order)
    nd_s = torch.gather(nd_cat, 1, order)
    ids_s = key_s >> 1
    dup = torch.cat([torch.zeros_like(ids_s[:, :1], dtype=torch.bool),
                     ids_s[:, 1:] == ids_s[:, :-1]], dim=1)
    alive = ((ids_s <= n - 1) if n else (ids_s < 0)) & ~dup
    fused_m = torch.where(alive, fused_s, torch.full_like(fused_s, NEG_INF))

    top_s, pos = stable_topk(fused_m, min(k, fused_m.shape[1]), dim=1)
    ok = top_s > NEG_INF / 2
    top_i = torch.where(ok, torch.gather(ids_s, 1, pos),
                        torch.full_like(pos, -1, dtype=torch.int32))
    top_s = torch.where(ok, top_s, torch.zeros_like(top_s))
    norms_at = torch.stack([torch.gather(nt_s, 1, pos),
                            torch.gather(ng_s, 1, pos),
                            torch.gather(nd_s, 1, pos)], dim=1)  # [B, 3, k]
    pad_k = k - top_s.shape[1]
    if pad_k > 0:
        top_s = torch.nn.functional.pad(top_s, (0, pad_k))
        top_i = torch.nn.functional.pad(top_i, (0, pad_k), value=-1)
        norms_at = torch.nn.functional.pad(norms_at, (0, pad_k))
    return top_s, top_i.to(torch.int32), norms_at
