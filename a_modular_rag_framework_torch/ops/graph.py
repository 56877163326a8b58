"""Multi-hop frontier expansion, in plain torch (port of
``a_modular_rag_framework_tpu/ops/graph.py``).

score[m] = max over seeds s of seed_val[s] * decay(d(s, m)), d <= window,
decay 1.0 / 0.7 / 0.5 / max(0.5 - 0.1*(d-2), 0.1).

Two families:

- the dense forms (`expand_frontier`, `expand_frontier_weighted`,
  `expand_frontier_weighted_capped`, `expand_frontier_weighted_batched`)
  hold the wave as a [..., N] buffer. Each takes any leading batch dims
  (``[N]`` is one query, ``[B, N]`` a batch), so the JAX ``vmap`` over
  rows is the same call on a [B, N] tensor;
- the compact form (`expand_frontier_weighted_compact`) holds the wave as
  an (ids, vals) pair, so no [B, N] buffer exists and the cost does not
  grow with the corpus. Its body, `expand_frontier_weighted_compact_core`,
  takes the adjacency-row gather as a function, as JAX's does: the
  single-device form gathers from one table, the sharded engine from the
  owning shards.

The neighbor table is symmetric, so "pull from my neighbors" equals
"push to them": the dense hops are gathers over each node's own row.
The capped hop scatters with ``scatter_reduce_(..., "amax")``, which does
not serialize on a GPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .topk import stable_topk

UNREACHED = 0x7FFFFFF


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


def _decay(window: int) -> list:
    """decay(d) for d = 0..window as Python floats holding the f32 values
    (a float32 tensor times one of them computes in f32, as JAX does)."""
    return hop_decay_table(max(window, 0)).tolist()


def expand_frontier(
    neighbors: torch.Tensor,  # [N, deg] int32, -1 padded (symmetric)
    seed_mask: torch.Tensor,  # [..., N] bool
    *,
    window: int,
    frontier_cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hop-decay BFS: (scores f32 [..., N], dist int32 [..., N]); a node's
    score is decay(BFS distance from the nearest seed), 0 when unreached
    within ``window`` hops.

    ``frontier_cap``: each hop expands only ``frontier_cap`` frontier nodes
    (the lowest ids among the frontier, ``lax.top_k``'s choice among equal
    scores) -- exact whenever the frontier fits."""
    N, deg = neighbors.shape
    dist = torch.where(seed_mask, 0, UNREACHED).to(torch.int32)
    safe_nbrs = neighbors.clamp(min=0).long()
    has_nbr = neighbors >= 0
    for h in range(1, max(window, 0) + 1):
        if frontier_cap:
            front = (dist == h - 1).float()
            _, idx = stable_topk(front, min(frontier_cap, N), dim=-1)
            is_front = torch.gather(dist, -1, idx) == h - 1
            rows = torch.where(is_front[..., None], neighbors[idx],
                               torch.full((), -1, dtype=neighbors.dtype,
                                          device=neighbors.device))
            flat = rows.flatten(-2).long()
            safe = torch.where(flat >= 0, flat, N)
            reach = torch.zeros((*dist.shape[:-1], N + 1), dtype=torch.bool,
                                device=dist.device).scatter_(-1, safe, True)
            reach = reach[..., :N]
        else:
            frontier = dist == h - 1
            reach = torch.any(frontier[..., safe_nbrs] & has_nbr, dim=-1)
        dist = torch.where(reach & (dist == UNREACHED), h, dist).to(torch.int32)
    # decay(d) at each reached node (d <= window by construction); a
    # where per distance keeps the table off the device
    scores = torch.zeros(dist.shape, dtype=torch.float32, device=dist.device)
    for d, v in enumerate(_decay(window)):
        scores = torch.where(dist == d, v, scores)
    return scores, dist


def expand_frontier_weighted(
    neighbors: torch.Tensor,  # [N, deg] int32, -1 padded (symmetric)
    seed_scores: torch.Tensor,  # [..., N] f32 (0 = not a seed)
    *,
    window: int,
    wave_dtype: str = "float32",
) -> torch.Tensor:
    """Seed-strength propagation [..., N] f32: one gather-max over the
    whole [..., N, deg] neighbor view per hop; the running max over hops
    is the result (revisits allowed).

    ``wave_dtype="bfloat16"`` rounds only the gathered wave; hop 0 keeps
    full f32 seed precision and ``best`` stays f32. Max is exact, so this
    form and `expand_frontier_weighted_batched` agree bit for bit."""
    N, deg = neighbors.shape
    decay = _decay(window)
    wdt = getattr(torch, wave_dtype)
    safe_nbrs = neighbors.clamp(min=0).long()
    has_nbr = neighbors >= 0
    seeds_f32 = torch.clamp(seed_scores, min=0.0).float()
    wave = seeds_f32.to(wdt)
    best = seeds_f32 * decay[0]
    zero = torch.zeros((), dtype=wdt, device=wave.device)
    for h in range(1, max(window, 0) + 1):
        if deg:
            wave = torch.amax(torch.where(has_nbr, wave[..., safe_nbrs], zero),
                              dim=-1)
        else:
            wave = torch.zeros_like(wave)
        best = torch.maximum(best, wave.float() * decay[h])
    return best


def expand_frontier_weighted_capped(
    neighbors: torch.Tensor,  # [N, deg] int32, -1 padded (symmetric)
    seed_scores: torch.Tensor,  # [..., N] f32
    *,
    window: int,
    frontier_cap: int = 256,
) -> torch.Tensor:
    """`expand_frontier_weighted` with per-hop frontier capping [..., N]:
    each hop gathers the adjacency rows of the top-``frontier_cap`` wave
    nodes only and scatter-maxes their values onto the neighbors. Exact
    whenever the live frontier fits the cap."""
    N, deg = neighbors.shape
    C = min(frontier_cap, N)
    decay = _decay(window)
    wave = torch.clamp(seed_scores.float(), min=0.0)
    best = wave * decay[0]
    lead = wave.shape[:-1]
    for h in range(1, max(window, 0) + 1):
        top_v, top_i = stable_topk(wave, C, dim=-1)
        rows = neighbors[top_i]  # [..., C, deg]
        live = (top_v > 0)[..., None] & (rows >= 0)
        dst = torch.where(live, rows.long(), N).flatten(-2)
        vals = torch.where(live, top_v[..., None].expand(rows.shape),
                           torch.zeros((), device=wave.device)).flatten(-2)
        wave = torch.zeros((*lead, N + 1), dtype=torch.float32,
                           device=wave.device).scatter_reduce_(
            -1, dst, vals, "amax")[..., :N]
        best = torch.maximum(best, wave * decay[h])
    return best


def expand_frontier_weighted_batched(
    neighbors: torch.Tensor,  # [N, deg] int32, -1 padded (symmetric)
    seed_scores: torch.Tensor,  # [B, N] f32
    *,
    window: int,
    wave_dtype: str = "float32",
) -> torch.Tensor:
    """`expand_frontier_weighted` without the [B, N, deg] intermediate
    (27 GB at B 2048, N 100k, deg 34): one [B, N] column gather per
    neighbor slot, max-folded in place, so two [B, N] buffers are live.
    The wave carries one zero column at index N where padded slots
    point, which is the JAX form's masked zero (waves are >= 0)."""
    N, deg = neighbors.shape
    decay = _decay(window)
    wdt = getattr(torch, wave_dtype)
    cols = torch.where(neighbors >= 0, neighbors, N).long().T.contiguous()
    seeds_f32 = torch.clamp(seed_scores, min=0.0).float()
    B = seeds_f32.shape[0]
    wave = seeds_f32.to(wdt)
    best = seeds_f32 * decay[0]
    wave_p = torch.zeros((B, N + 1), dtype=wdt, device=wave.device)
    g = torch.empty((B, N), dtype=wdt, device=wave.device)
    for h in range(1, max(window, 0) + 1):
        wave_p[:, :N] = wave
        new = torch.zeros((B, N), dtype=wdt, device=wave.device)
        for d in range(deg):
            torch.index_select(wave_p, 1, cols[d], out=g)
            torch.maximum(new, g, out=new)
        wave = new
        best = torch.maximum(best, wave.float() * decay[h])
    return best


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

    def gather_rows(src_ids):
        # clamp: padded wave slots hold id N, which must not index the table
        return neighbors[src_ids.long().clamp(0, max(N - 1, 0))]

    return expand_frontier_weighted_compact_core(
        gather_rows, seed_ids, seed_vals, n_nodes=N, window=window, cap=cap,
        out_k=out_k)


def expand_frontier_weighted_compact_core(
    gather_rows,  # [B, C] int32 node ids -> [B, C, deg] int32 rows, -1 pad
    seed_ids: torch.Tensor,  # [B, S] int32 global rows, -1 padded
    seed_vals: torch.Tensor,  # [B, S] f32 seed strengths (<= 0 = invalid)
    *,
    n_nodes: int,
    window: int,
    cap: int = 512,
    out_k: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`expand_frontier_weighted_compact` with the adjacency rows read by
    ``gather_rows``, which receives ids in [0, n_nodes] (n_nodes marks a
    padded wave slot, whose row is never used)."""
    N = n_nodes
    B = seed_ids.shape[0]
    decay = _decay(window)

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
        rows = gather_rows(src_ids)  # [B, C, deg]
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


def build_neighbor_table(
    n_nodes: int,
    edges_src: np.ndarray,
    edges_dst: np.ndarray,
    max_degree: int,
) -> np.ndarray:
    """Pack an undirected neighbor table [N, max_degree] (-1 padded) from a
    COO edge list; both directions inserted (BFS uses fwd+bwd neighbors).
    Host numpy, copied from the JAX package's ``ops/graph.py``."""
    nbrs = np.full((n_nodes, max_degree), -1, dtype=np.int32)
    counts = np.zeros(n_nodes, dtype=np.int32)

    def add(a: int, b: int):
        if counts[a] < max_degree:
            nbrs[a, counts[a]] = b
            counts[a] += 1

    for s, t in zip(edges_src.tolist(), edges_dst.tolist()):
        add(s, t)
        add(t, s)
    return nbrs
