"""Compact multi-hop frontier expansion, in plain torch (port of
``hop_decay_table``, ``_segmax_by_id`` and
``expand_frontier_weighted_compact`` / ``_core`` in
``a_modular_rag_framework_tpu/ops/graph.py``; the port has one row
gather, so the two are one function here).

score[m] = max over seeds s of seed_val[s] * decay(d(s, m)), d <= window,
decay 1.0 / 0.7 / 0.5 / max(0.5 - 0.1*(d-2), 0.1). The wave is a compact
(ids, vals) pair, so no [B, N] buffer exists and the cost does not grow
with the corpus.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .topk import stable_topk


def hop_decay_table(max_hops: int) -> np.ndarray:
    """decay(d) for d = 0..max_hops."""
    out = []
    for d in range(max_hops + 1):
        if d == 0:
            out.append(1.0)
        elif d == 1:
            out.append(0.7)
        elif d == 2:
            out.append(0.5)
        else:
            out.append(max(0.5 - 0.1 * (d - 2), 0.1))
    return np.array(out, dtype=np.float32)


def _segmax_by_id(ids: torch.Tensor, vals: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort rows by (id asc, val desc) -- two stable sorts, secondary key
    first -- so each equal-id run starts with its max. Returns
    (sorted ids, sorted vals, is_run_start)."""
    o1 = torch.sort(vals, dim=1, descending=True, stable=True).indices
    ids1 = torch.gather(ids, 1, o1)
    o2 = torch.sort(ids1, dim=1, stable=True).indices
    d = torch.gather(ids1, 1, o2)
    v = torch.gather(torch.gather(vals, 1, o1), 1, o2)
    first = torch.cat([torch.ones_like(d[:, :1], dtype=torch.bool),
                       d[:, 1:] != d[:, :-1]], dim=1)
    return d, v, first


def expand_frontier_weighted_compact(
    neighbors: torch.Tensor,  # [N, deg] int32, -1 padded (symmetric)
    seed_ids: torch.Tensor,  # [B, S] int32 global rows, -1 padded
    seed_vals: torch.Tensor,  # [B, S] f32 seed strengths (<= 0 = invalid)
    *,
    window: int,
    cap: int = 512,
    out_k: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g_scores f32 [B, out_k'], g_ids int32 [B, out_k'], -1 padded),
    sorted by score descending.

    Truncation contract: only the top-``cap`` wave nodes PROPAGATE to the
    next hop, but every node a propagating hop reaches is recorded. Exact
    while each hop's live frontier fits ``cap`` and the reached set fits
    ``out_k``."""
    N = neighbors.shape[0]
    B = seed_ids.shape[0]
    decay = hop_decay_table(max(window, 0)).tolist()

    valid0 = (seed_ids >= 0) & (seed_vals > 0)
    wave_ids = torch.where(valid0, seed_ids.to(torch.int32),
                           torch.full_like(seed_ids, N, dtype=torch.int32))
    wave_vals = torch.where(valid0, seed_vals.float(),
                            torch.zeros_like(seed_vals, dtype=torch.float32))
    acc_ids = [wave_ids]
    acc_vals = [wave_vals * decay[0]]
    for h in range(1, max(window, 0) + 1):
        C = min(cap, wave_vals.shape[1])
        src_vals, pos = stable_topk(wave_vals, C, dim=1)
        src_ids = torch.gather(wave_ids, 1, pos)
        # clamp: padded wave slots hold id N, which must not index the table
        rows = neighbors[src_ids.long().clamp(0, max(N - 1, 0))]  # [B, C, deg]
        live = ((src_vals > 0)[:, :, None] & (src_ids < N)[:, :, None]
                & (rows >= 0))
        cand_ids = torch.where(live, rows.to(torch.int32),
                               torch.full_like(rows, N, dtype=torch.int32)
                               ).reshape(B, -1)
        cand_vals = torch.where(live, src_vals[:, :, None].expand(rows.shape),
                                torch.zeros(rows.shape, dtype=torch.float32,
                                            device=rows.device)
                                ).reshape(B, -1)
        d, v, start = _segmax_by_id(cand_ids, cand_vals)
        reached = start & (d < N)
        wave_ids = torch.where(reached, d, torch.full_like(d, N))
        wave_vals = torch.where(reached, v, torch.zeros_like(v))
        acc_ids.append(wave_ids)
        acc_vals.append(wave_vals * decay[h])

    d, v, start = _segmax_by_id(torch.cat(acc_ids, dim=1),
                                torch.cat(acc_vals, dim=1))
    end_vals = torch.where(start & (d < N), v, torch.zeros_like(v))
    K = min(out_k, end_vals.shape[1])
    g_s, pos = stable_topk(end_vals, K, dim=1)
    g_i = torch.where(g_s > 0, torch.gather(d, 1, pos),
                      torch.full_like(pos, -1, dtype=torch.int32))
    return g_s, g_i.to(torch.int32)
