"""Sharded dense and learned-sparse retrieval: corpus rows split over a
mesh axis (port of ``a_modular_rag_framework_tpu/parallel/sharded.py``).

Each shard takes a local top-k over its own rows, its ids are offset by
the shard's first global row, the shards' ``[B, k]`` pairs are gathered in
shard order on the lead device, and one stable top-k merges them. Shards
hold consecutive row ranges and each local list is ordered (score desc, id
asc), so equal scores resolve by ascending global id, the order of the
single-device top-k. No ``[B, N]`` score matrix exists on any device.

The dense local top-k is `ops.topk.dense_topk`: the hand-written CUDA
kernel on a card, its plain version on the CPU. Every shard gets its real
rows only (the last shard may be shorter), so no padded row reaches the
kernel. The JAX version takes the XLA top-k per shard; the port's dense
path is the same function.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .._host import to_device
from ..ops.bm25 import bm25_topk_sorted
from ..ops.topk import dense_topk, stable_topk
from .collectives import all_gather
from .mesh import DeviceMesh


@dataclass
class ShardedRows:
    """An [N, d] row table split over a mesh axis: shard ``s`` holds the
    rows ``bases[s] .. bases[s] + len(shards[s])`` on ``devices[s]``."""

    shards: List[torch.Tensor]
    bases: List[int]
    devices: List[torch.device]
    n_rows: int


def shard_corpus_rows(emb: torch.Tensor, mesh: DeviceMesh,
                      axis: str = "data") -> ShardedRows:
    """Split [N, d] rows over ``axis`` (over the first group of the other
    axes: a replica there computes the same result) into blocks of
    ceil(N / S) rows (the last may be shorter) and place each block on its
    position's device."""
    devices = mesh.groups(axis)[0]
    n = int(emb.shape[0])
    n_local = -(-max(n, 1) // len(devices))
    bases = [s * n_local for s in range(len(devices))]
    shards = [emb[b: min(b + n_local, n)].to(dev).contiguous()
              for b, dev in zip(bases, devices)]
    return ShardedRows(shards, bases, devices, n)


def merge_topk(scores: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
               k: int, dst) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the shards' (scores [B, k_s], global ids [B, k_s]) in shard
    order on ``dst`` and keep the top ``k`` (stable: ascending position,
    so ascending global id among equal scores)."""
    cat_s = all_gather(scores, dst, dim=1)
    cat_i = all_gather(ids, dst, dim=1)
    top_s, pos = stable_topk(cat_s, k, dim=1)
    return top_s, torch.gather(cat_i, 1, pos)


def sharded_dense_topk(q: torch.Tensor, rows: ShardedRows, k: int,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (scores f32 [B, k], ids int32 [B, k]) of ``q @ D^T`` over a
    row-sharded corpus, on the first shard's device. Per shard: the local
    top-min(k, rows) through `dense_topk`, ids offset to global rows; then
    the merge. ``k <= N``."""
    if k > rows.n_rows:
        raise ValueError(f"k={k} > corpus size {rows.n_rows}")
    dst = rows.devices[0]
    part_s, part_i = [], []
    for emb_l, base, dev in zip(rows.shards, rows.bases, rows.devices):
        if emb_l.shape[0] == 0:
            continue
        s, i = dense_topk(q.to(dev).contiguous(), emb_l,
                          min(k, int(emb_l.shape[0])))
        part_s.append(s)
        part_i.append(i + base)
    return merge_topk(part_s, part_i, k, dst)


# ---------------- learned sparse (SPLADE) channel ----------------


def shard_splade_postings(index, n_shards: int):
    """Partition an impact CSR (`ops.splade.SpladeDeviceIndex`) by doc
    ranges: doc d belongs to shard ``d // rows_per_shard``, and each shard
    gets its own CSR over its local rows, each term's postings kept in
    their impact-descending order (a stable filter), padded to the largest
    shard's posting count and stacked.

    Returns (doc_ids [S, Pmax] i32 local rows, impacts [S, Pmax] f32,
    row_ptr [S, V+1] i32, rows_per_shard), host numpy."""
    V = index.row_ptr.shape[0] - 1
    rows_per_shard = -(-index.n_docs // n_shards)
    shard_of = index.doc_ids // rows_per_shard
    per_doc_local = index.doc_ids - shard_of * rows_per_shard

    term_of = np.repeat(np.arange(V, dtype=np.int64),
                        np.diff(index.row_ptr).astype(np.int64))
    counts = np.zeros((n_shards, V), dtype=np.int64)
    np.add.at(counts, (shard_of, term_of), 1)
    row_ptrs = np.zeros((n_shards, V + 1), dtype=np.int32)
    np.cumsum(counts, axis=1, out=row_ptrs[:, 1:])

    p_max = max(int(row_ptrs[:, -1].max()), 1)
    doc_ids = np.zeros((n_shards, p_max), dtype=np.int32)
    impacts = np.zeros((n_shards, p_max), dtype=np.float32)
    # order by (shard, term, original position): the impact-descending order
    # inside each (shard, term) run is kept
    order = np.lexsort((np.arange(term_of.shape[0]), term_of, shard_of))
    so = shard_of[order]
    shard_starts = np.searchsorted(so, np.arange(n_shards))
    pos = np.arange(order.shape[0]) - shard_starts[so]
    doc_ids[so, pos] = per_doc_local[order]
    impacts[so, pos] = index.impacts[order]
    return doc_ids, impacts, row_ptrs, rows_per_shard


def sharded_splade_topk(
    term_ids: torch.Tensor,  # [B, T] i32, -1 padded
    term_weights: torch.Tensor,  # [B, T] f32 >= 0
    doc_ids: np.ndarray,  # [S, Pmax] from shard_splade_postings
    impacts: np.ndarray,  # [S, Pmax]
    row_ptrs: np.ndarray,  # [S, V+1]
    *,
    mesh: DeviceMesh,
    rows_per_shard: int,
    n_docs: int,
    k: int,
    term_topm: int = 256,
    axis: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global learned-sparse top-k over doc-range-sharded impact postings:
    per shard, windowed posting scoring (`ops.bm25.bm25_topk_sorted` with
    per-term weights) over the LOCAL CSR, ids offset to global rows (padded
    tail rows dropped), then the merge; zero scores give id -1. Exact
    against the single-device scorer whenever ``term_topm`` covers each
    term's local posting list."""
    devices = mesh.groups(axis)[0]
    B, T = term_ids.shape
    part_s, part_i = [], []
    for sh, dev in enumerate(devices):
        s, i = bm25_topk_sorted(
            term_ids.to(dev).reshape(B, 1, T), to_device(doc_ids[sh], dev),
            to_device(impacts[sh], dev), to_device(row_ptrs[sh], dev),
            n_docs=rows_per_shard,
            term_topm=min(term_topm, rows_per_shard), pool_k=k,
            term_weights=term_weights.to(dev).reshape(B, 1, T))
        gi = torch.where(i >= 0, i + sh * rows_per_shard,
                         torch.full_like(i, -1))
        gi = torch.where(gi >= n_docs, torch.full_like(gi, -1), gi)
        s = torch.where(gi >= 0, s, torch.zeros_like(s))
        pad = k - s.shape[1]  # a shard's window may hold fewer than k docs
        if pad > 0:
            s = torch.nn.functional.pad(s, (0, pad))
            gi = torch.nn.functional.pad(gi, (0, pad), value=-1)
        part_s.append(s)
        part_i.append(gi)
    top_s, picked = merge_topk(part_s, part_i, k, devices[0])
    return top_s, torch.where(top_s > 0, picked, torch.full_like(picked, -1))
