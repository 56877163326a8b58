"""BM25 on device, in plain torch (port of ``bm25_topk_sorted``,
``bm25_rescore_pool``, ``bm25_scores_batched`` and ``bm25_scores`` in
``a_modular_rag_framework_tpu/ops/bm25.py``).

The engine's default text channel is scatter-free. Phase 1 (`bm25_topk_sorted`) selects a candidate pool: each query-term
occurrence gathers its top-``term_topm`` postings, a variant's windows are
sorted by doc id and equal-id runs summed (cumsum + cummax base), and
variants are max-merged by a second sort. Phase 2 (`bm25_rescore_pool`)
re-scores the pool exactly from the doc-major padded table.

`bm25_scores_batched` is the scatter form (``bm25_impl="scatter"``): every
term's top-``cap`` postings land in a [B*E, N+1] buffer with one
``index_add_`` (slot N is the dump for padding), and the E variants merge
by max or sum. The JAX scatter-add order is not promised either, and on a
GPU ``index_add_`` adds with atomics, so sums agree to f32 rounding.
`bm25_scores` is the per-query oracle that computes contributions from
term frequencies.

Index dtypes: public inputs and outputs are int32 as in JAX; gathers cast
to int64 where torch needs it. Every pad row and clamp of the JAX code is
kept: an out-of-range read on CUDA is a device-side assert, not a clamp.
Within an equal-doc run the summation order follows the sort (JAX's sort
is not stable), so phase-1 run totals may differ from JAX's by ulps.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .topk import stable_topk


def _run_ends(keys: torch.Tensor) -> torch.Tensor:
    """True at the last entry of each equal-key run along dim 1."""
    last = torch.ones_like(keys[:, :1], dtype=torch.bool)
    return torch.cat([keys[:, 1:] != keys[:, :-1], last], dim=1)


def _posting_windows(
    term_ids: torch.Tensor,  # [..., T] int32, -1 padded
    doc_ids: torch.Tensor,  # [P] int32
    values: torch.Tensor,  # [P] f32
    row_ptr: torch.Tensor,  # [V+1] int32
    *,
    n_docs: int,
    cap: int,
    posting_packed: Optional[torch.Tensor] = None,  # [P, 2] (id, f32 bits)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each term occurrence's first ``cap`` postings, (docs int32 [M, cap],
    values f32 [M, cap]) for the M = term_ids.numel() occurrences; slots
    past a posting list's end, and -1 terms, hold doc ``n_docs`` and value
    0. ``posting_packed`` serves (doc, value) pairs from one gather."""
    N = n_docs
    dev = term_ids.device
    flat_t = term_ids.reshape(-1).long()
    valid = flat_t >= 0
    t_safe = flat_t.clamp(min=0)
    starts = row_ptr[t_safe].long()
    lengths = torch.clamp(row_ptr[t_safe + 1].long() - starts, max=cap)

    j = torch.arange(cap, device=dev)[None, :]
    win_idx = starts[:, None] + j  # [M, cap]; pad rows cover the overrun
    in_range = (j < lengths[:, None]) & valid[:, None]
    if posting_packed is not None:
        pad = torch.zeros((cap, 2), dtype=torch.int32, device=dev)
        pad[:, 0] = N
        rows = torch.cat([posting_packed, pad])[win_idx.reshape(-1)]
        docs_w = rows[:, 0].reshape(win_idx.shape)
        vals_w = rows[:, 1].contiguous().view(torch.float32).reshape(
            win_idx.shape)
    else:
        doc_ids_p = torch.cat(
            [doc_ids, torch.full((cap,), N, dtype=torch.int32, device=dev)])
        values_p = torch.cat(
            [values, torch.zeros((cap,), dtype=torch.float32, device=dev)])
        docs_w = doc_ids_p[win_idx]
        vals_w = values_p[win_idx]
    docs_w = torch.where(in_range, docs_w,
                         torch.full_like(docs_w, N)).to(torch.int32)
    vals_w = torch.where(in_range, vals_w, torch.zeros_like(vals_w))
    return docs_w, vals_w


def bm25_topk_sorted(
    term_ids: torch.Tensor,  # [B, E, T] int32, -1 padded
    doc_ids: torch.Tensor,  # [P] int32 (contribution-sorted within each term)
    contribs: torch.Tensor,  # [P] f32
    row_ptr: torch.Tensor,  # [V+1] int32
    *,
    n_docs: int,
    term_topm: int = 64,
    pool_k: int = 200,
    posting_packed: Optional[torch.Tensor] = None,  # [P, 2] (id, score bits)
    term_weights: Optional[torch.Tensor] = None,  # [B, E, T] f32 >= 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pool scores f32 [B, K], pool ids int32 [B, K], -1 padded), K =
    min(pool_k, E*T*term_topm), sorted by score descending.

    ``term_weights`` scales each term occurrence's contributions (the
    learned-sparse seam); weights must be >= 0 for the cummax run base."""
    B, E, T = term_ids.shape
    N = n_docs
    m = term_topm

    docs_w, c_w = _posting_windows(term_ids, doc_ids, contribs, row_ptr,
                                   n_docs=N, cap=m,
                                   posting_packed=posting_packed)
    if term_weights is not None:
        c_w = c_w * term_weights.reshape(-1)[:, None]

    W = T * m
    docs_q = docs_w.reshape(B * E, W)
    c_q = c_w.reshape(B * E, W)

    # sort by doc id; the contributions ride as payload
    docs_s, order = torch.sort(docs_q, dim=1, stable=True)
    c_s = torch.gather(c_q, 1, order)

    boundary = torch.cat(
        [torch.ones_like(docs_s[:, :1], dtype=torch.bool),
         docs_s[:, 1:] != docs_s[:, :-1]], dim=1)
    c_cum = torch.cumsum(c_s, dim=1)
    # each run's base = c_cum just before the run start, carried across the
    # run by a cummax (contributions >= 0, so c_cum is nondecreasing)
    prev_cum = torch.cat([torch.zeros_like(c_cum[:, :1]), c_cum[:, :-1]],
                         dim=1)
    base = torch.cummax(torch.where(boundary, prev_cum,
                                    torch.zeros_like(prev_cum)), dim=1).values
    run_total = c_cum - base
    score_at = torch.where(_run_ends(docs_s) & (docs_s < N), run_total,
                           torch.zeros_like(run_total))

    # per-variant top pool, then max-merge variants by doc id
    K = min(pool_k, W)
    v_s, v_pos = stable_topk(score_at, K, dim=1)
    v_docs = torch.gather(docs_s, 1, v_pos)
    v_docs = torch.where(v_s > 0, v_docs, torch.full_like(v_docs, N))

    u_docs = v_docs.reshape(B, E * K)
    u_s = v_s.reshape(B, E * K)
    if E > 1:
        # a doc appears at most E times (contiguously after the sort): its
        # max over the E-1 preceding equal-id lanes, read at the run's end
        d2, order2 = torch.sort(u_docs, dim=1, stable=True)
        s2 = torch.gather(u_s, 1, order2)
        merged = s2
        neg = torch.full_like(s2, float("-inf"))
        for shift in range(1, E):
            if shift >= d2.shape[1]:
                break
            same = torch.zeros_like(d2, dtype=torch.bool)
            same[:, shift:] = d2[:, shift:] == d2[:, :-shift]
            prev = torch.cat([neg[:, :shift], s2[:, :-shift]], dim=1)
            merged = torch.maximum(merged, torch.where(same, prev, neg))
        final_s = torch.where(_run_ends(d2) & (d2 < N), merged,
                              torch.zeros_like(merged))
        top_s, pos = stable_topk(final_s, min(pool_k, final_s.shape[1]), dim=1)
        top_d = torch.gather(d2, 1, pos)
    else:
        top_s, pos = stable_topk(u_s, min(pool_k, u_s.shape[1]), dim=1)
        top_d = torch.gather(u_docs, 1, pos)

    top_d = torch.where(top_s > 0, top_d, torch.full_like(top_d, -1))
    return top_s, top_d.to(torch.int32)


def bm25_rescore_pool(
    pool_i: torch.Tensor,  # [B, K] int32 candidate rows, -1 padded
    term_ids: torch.Tensor,  # [B, E, T] int32 query term occurrences, -1 pad
    doc_terms_padded: torch.Tensor,  # [N, D] int32 doc-major term ids, -2 pad
    doc_scores_padded: torch.Tensor,  # [N, D] f32 doc-major contributions
    *,
    n_docs: int,
    term_weights: Optional[torch.Tensor] = None,  # [B, E, T] f32 >= 0
) -> torch.Tensor:
    """EXACT BM25 scores [B, K] for the pool, max over variants. Each query
    term OCCURRENCE counts (duplicate terms score twice)."""
    B, K = pool_i.shape
    flat = pool_i.reshape(-1).long()
    ok = flat >= 0
    safe = torch.where(ok, flat, torch.zeros_like(flat))
    wt = doc_terms_padded[safe]  # [B*K, D]
    wc = doc_scores_padded[safe]
    wt = torch.where(ok[:, None], wt, torch.full_like(wt, -2))
    wc = torch.where(ok[:, None], wc, torch.zeros_like(wc))
    D = wt.shape[1]
    wt_b = wt.reshape(B, 1, K, D)
    wc_b = wc.reshape(B, 1, K, D)
    E, T = term_ids.shape[1], term_ids.shape[2]

    # one [B, E, K, D] compare + masked reduce per query-term slot, summed in
    # slot order (the JAX fori_loop's order)
    acc = torch.zeros((B, E, K), dtype=torch.float32, device=pool_i.device)
    for t in range(T):
        tid_t = term_ids[:, :, t]  # [B, E]
        match = (wt_b == tid_t[:, :, None, None]) & (tid_t >= 0)[:, :, None, None]
        contrib = torch.sum(torch.where(match, wc_b, torch.zeros_like(wc_b)),
                            dim=-1)
        if term_weights is not None:
            contrib = contrib * term_weights[:, :, t][:, :, None]
        acc = acc + contrib
    return torch.amax(acc, dim=1)


def bm25_scores_batched(
    term_ids: torch.Tensor,  # [B, E, T] int32, -1 padded (E query variants)
    doc_ids: torch.Tensor,  # [P] int32
    contribs: torch.Tensor,  # [P] f32 precomputed c(t, d)
    row_ptr: torch.Tensor,  # [V+1] int32
    *,
    n_docs: int,
    cap: int,
    merge: str = "max",
) -> torch.Tensor:
    """[B, N] BM25 scores: each term occurrence's top-``cap`` contributions
    scatter-added per variant, then merged over the E variants (``max``
    or ``sum``)."""
    B, E, T = term_ids.shape
    N = n_docs
    docs, c = _posting_windows(term_ids, doc_ids, contribs, row_ptr,
                               n_docs=N, cap=cap)
    variant = torch.arange(B * E * T, device=term_ids.device)[:, None] // T
    acc = torch.zeros((B * E) * (N + 1), dtype=torch.float32,
                      device=term_ids.device)
    acc.index_add_(0, (variant * (N + 1) + docs).reshape(-1), c.reshape(-1))
    per_variant = acc.view(B, E, N + 1)[:, :, :N]
    if merge == "sum":
        return per_variant.sum(dim=1)
    return per_variant.amax(dim=1)


def bm25_scores(
    term_ids: torch.Tensor,  # [Q, T] int32, -1 padded
    doc_ids: torch.Tensor,  # [P] int32
    tfs: torch.Tensor,  # [P] f32
    row_ptr: torch.Tensor,  # [V+1] int32
    df: torch.Tensor,  # [V] f32
    doc_lens: torch.Tensor,  # [N] f32
    *,
    n_docs: int,
    cap: int = 4096,
    merge: str = "max",
    k1: float = 1.5,
    b: float = 0.75,
) -> torch.Tensor:
    """Dense BM25 from term frequencies: merged [N] when ``merge`` is
    ``max`` or ``sum``, else per-query [Q, N]."""
    Q, T = term_ids.shape
    N = n_docs
    avgdl = doc_lens.mean()
    avgdl = torch.where(avgdl > 0, avgdl, torch.ones_like(avgdl))
    docs, f = _posting_windows(term_ids, doc_ids, tfs, row_ptr, n_docs=N,
                               cap=cap)
    in_range = docs < N
    dl = doc_lens[docs.clamp(max=N - 1).long()]
    n_t = df[term_ids.reshape(-1).long().clamp(min=0)][:, None]
    idf = torch.log((float(N) - n_t + 0.5) / (n_t + 0.5) + 1.0)
    denom = f + k1 * (1.0 - b + b * dl / avgdl)
    contrib = idf * f * (k1 + 1.0) / torch.where(denom > 0, denom,
                                                 torch.ones_like(denom))
    contrib = torch.where(in_range, contrib, torch.zeros_like(contrib))
    query = torch.arange(Q * T, device=term_ids.device)[:, None] // T
    acc = torch.zeros(Q * (N + 1), dtype=torch.float32,
                      device=term_ids.device)
    acc.index_add_(0, (query * (N + 1) + docs).reshape(-1),
                   contrib.reshape(-1))
    per_query = acc.view(Q, N + 1)[:, :N]
    if merge == "max":
        return per_query.amax(dim=0)
    if merge == "sum":
        return per_query.sum(dim=0)
    return per_query
