"""Learned-sparse (SPLADE) retrieval over impact-sorted CSR postings (port
of ``a_modular_rag_framework_tpu/ops/splade.py``).

The doc side runs the expansion model over the corpus in device batches at
index-build time and stores each kept term's postings as (doc id, impact)
sorted by impact descending — the layout the BM25 channel uses for its
precomputed contributions, so query scoring reuses `bm25_topk_sorted`
with the per-term query weights riding its ``term_weights`` seam:

    score(q, d) = sum_t w_q(t) * impact_d(t)

`SpladeDeviceIndex` is host data with the original's ``.npz`` layout, so an
index saved by either package loads in the other.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._host import to_device
from ..models.encoder import encode_hidden, pool_normalize
from ..models.splade import (SpladeConfig, SpladeEncoder, apply_splade,
                             sparsify_topk, splade_from_hidden)
from .bm25 import bm25_topk_sorted
from .topk import stable_topk


@dataclass
class SpladeDeviceIndex:
    """Impact-sorted CSR postings over the hashed expansion vocabulary."""

    doc_ids: np.ndarray   # int32 [P] posting doc rows
    impacts: np.ndarray   # f32  [P] doc-side term weights
    row_ptr: np.ndarray   # int32 [V+1]
    n_docs: int

    @classmethod
    def from_expansions(cls, term_ids: np.ndarray, weights: np.ndarray,
                        vocab_size: int) -> "SpladeDeviceIndex":
        """Assemble CSR from per-doc sparse expansions ([N, K] ids with -1
        padding, [N, K] weights). Vectorized host pass; postings within a
        term sort by impact descending (ties by doc id for determinism)."""
        N, K = term_ids.shape
        flat_t = term_ids.reshape(-1)
        flat_w = weights.reshape(-1).astype(np.float32)
        flat_d = np.repeat(np.arange(N, dtype=np.int32), K)
        keep = (flat_t >= 0) & (flat_w > 0)
        flat_t, flat_w, flat_d = flat_t[keep], flat_w[keep], flat_d[keep]
        order = np.lexsort((flat_d, -flat_w, flat_t))
        flat_t, flat_w, flat_d = flat_t[order], flat_w[order], flat_d[order]
        counts = np.bincount(flat_t, minlength=vocab_size)
        row_ptr = np.zeros(vocab_size + 1, dtype=np.int32)
        np.cumsum(counts, out=row_ptr[1:])
        return cls(doc_ids=flat_d.astype(np.int32),
                   impacts=flat_w,
                   row_ptr=row_ptr,
                   n_docs=N)

    def save(self, path: str) -> None:
        np.savez(path, doc_ids=self.doc_ids, impacts=self.impacts,
                 row_ptr=self.row_ptr, n_docs=np.int64(self.n_docs))

    @classmethod
    def load(cls, path: str) -> "SpladeDeviceIndex":
        d = np.load(path)
        return cls(doc_ids=d["doc_ids"], impacts=d["impacts"],
                   row_ptr=d["row_ptr"], n_docs=int(d["n_docs"]))


def splade_engine_arrays(index: SpladeDeviceIndex, doc_top_terms: int,
                         device) -> Dict[str, torch.Tensor]:
    """Engine-shaped tensors on ``device`` for `TorchQueryEngine`'s text
    channel (the keys of `Bm25Index.device_tensors`): term-major CSR
    postings plus the doc-major padded layout the exact re-score gathers.

    The doc-major arrays invert the CSR: postings sorted by doc row
    (stable, so each doc's terms keep their term-id order); every doc holds
    at most ``doc_top_terms`` expansion terms by construction, so the fixed
    stride is exact. ``posting_packed`` ((doc id, impact bits) pairs, one
    gather per posting) is built while it stays within 256 MB."""
    n_docs = index.n_docs
    term_per_post = np.repeat(
        np.arange(len(index.row_ptr) - 1, dtype=np.int32),
        np.diff(index.row_ptr))
    order = np.argsort(index.doc_ids, kind="stable")
    d_s = np.asarray(index.doc_ids)[order]
    t_s = term_per_post[order]
    w_s = np.asarray(index.impacts, dtype=np.float32)[order]
    counts = np.bincount(d_s, minlength=n_docs)
    D = max(1, int(doc_top_terms))
    doc_terms = np.full((n_docs, D), -2, dtype=np.int32)
    doc_scores = np.zeros((n_docs, D), dtype=np.float32)
    starts = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(d_s.shape[0], dtype=np.int64) - starts[d_s]
    keep = slot < D
    doc_terms[d_s[keep], slot[keep]] = t_s[keep]
    doc_scores[d_s[keep], slot[keep]] = w_s[keep]
    doc_ids = np.asarray(index.doc_ids, dtype=np.int32)
    impacts = np.asarray(index.impacts, dtype=np.float32)
    out = {
        "doc_ids": to_device(doc_ids, device),
        "scores": to_device(impacts, device),
        "row_ptr": to_device(np.asarray(index.row_ptr, dtype=np.int32),
                             device),
        "doc_terms_padded": to_device(doc_terms, device),
        "doc_scores_padded": to_device(doc_scores, device),
    }
    if index.doc_ids.size * 8 <= (256 << 20):
        out["posting_packed"] = to_device(
            np.stack([doc_ids, impacts.view(np.int32)], axis=1), device)
    return out


def _posting_tensors(index: SpladeDeviceIndex, device):
    return (to_device(index.doc_ids, device), to_device(index.impacts, device),
            to_device(index.row_ptr, device))


class SpladeRetriever:
    """Standalone learned-sparse retriever: build + batched device query.

    Usage:
        enc = SpladeEncoder.load("splade.npz")   # or fresh for tests
        r = SpladeRetriever(enc)
        r.build(corpus_texts)                    # device-batched expansion
        ids, scores = r.query_batch(queries, top_k=10)
    """

    def __init__(self, encoder: SpladeEncoder, *,
                 term_topm: int = 256, build_batch: int = 512):
        self.encoder = encoder
        self.cfg: SpladeConfig = encoder.cfg
        self.term_topm = int(term_topm)
        self.build_batch = int(build_batch)
        self.index: Optional[SpladeDeviceIndex] = None
        self._dev = None       # (doc_ids, impacts, row_ptr) on the device
        # seconds of the last build: expansion (host tokenize + device),
        # then the host CSR assembly
        self.build_stats: Dict[str, float] = {}

    # ---- build ----

    def build(self, texts: Sequence[str]) -> SpladeDeviceIndex:
        """Expand the corpus in device batches (the tail is padded with
        empty texts to the batch shape, as in the original)."""
        texts = list(texts)
        N, Bb = len(texts), self.build_batch
        K = self.cfg.doc_top_terms
        all_ids = np.full((N, K), -1, dtype=np.int32)
        all_w = np.zeros((N, K), dtype=np.float32)
        t0 = time.time()
        for start in range(0, N, Bb):
            chunk = texts[start:start + Bb]
            pad = Bb - len(chunk)
            ids, w = self.encoder.expand_texts(chunk + [""] * pad, k=K)
            all_ids[start:start + len(chunk)] = ids[: len(chunk)]
            all_w[start:start + len(chunk)] = w[: len(chunk)]
        t1 = time.time()
        self.set_index(SpladeDeviceIndex.from_expansions(
            all_ids, all_w, self.cfg.vocab_size))
        self.build_stats = {"docs": N, "expand_sec": t1 - t0,
                            "assemble_sec": time.time() - t1}
        return self.index

    def set_index(self, index: SpladeDeviceIndex) -> None:
        self.index = index
        self._dev = _posting_tensors(index, self.encoder.device)

    # ---- query ----

    @torch.no_grad()
    def query_batch(self, queries: Sequence[str], top_k: int = 10
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (doc ids [B, top_k] int32 with -1 padding, scores [B, top_k]):
        the encoder and the posting scorer in one device program."""
        if self.index is None:
            raise RuntimeError("SpladeRetriever.build() first")
        enc = self.encoder
        tok_ids, mask = enc.host_featurize(list(queries))
        n_docs = self.index.n_docs
        w = apply_splade(enc.params, to_device(tok_ids, enc.device),
                         to_device(mask, enc.device), self.cfg)
        t_ids, t_w = sparsify_topk(w, self.cfg.query_top_terms)
        B, T = t_ids.shape
        scores, ids = bm25_topk_sorted(
            t_ids.reshape(B, 1, T), *self._dev, n_docs=n_docs,
            term_topm=min(self.term_topm, n_docs), pool_k=top_k,
            term_weights=t_w.reshape(B, 1, T))
        return ids.cpu().numpy(), scores.cpu().numpy()

    # ---- oracle (tests) ----

    def score_dense_oracle(self, queries: Sequence[str]) -> np.ndarray:
        """[B, N] exact scores via dense expansion vectors and the sparse
        doc matrix — the parity oracle for the CSR program (only docs'
        kept top-K terms participate, matching the index contents)."""
        if self.index is None:
            raise RuntimeError("SpladeRetriever.build() first")
        wq = self.encoder.dense_expand(list(queries))  # [B, V]
        t_ids, t_w = sparsify_topk(torch.from_numpy(wq),
                                   self.cfg.query_top_terms)
        t_ids, t_w = t_ids.numpy(), t_w.numpy()
        V, N = self.cfg.vocab_size, self.index.n_docs
        idx = self.index
        docs = np.zeros((N, V), dtype=np.float32)
        term_per_post = np.repeat(np.arange(V), np.diff(idx.row_ptr))
        docs[idx.doc_ids, term_per_post] = idx.impacts
        out = np.zeros((len(queries), N), dtype=np.float32)
        for b in range(len(queries)):
            for j, t in enumerate(t_ids[b]):
                if t >= 0:
                    out[b] += t_w[b, j] * docs[:, t]
        return out


class SpladeDenseHybrid:
    """SPLADE posting scores select a candidate pool, dense cosine over
    the pool rows fuses in (min-max normalized, weighted sum), optionally
    followed by a cross-encoder rerank batch.

    The trunk runs once per query batch: both the expansion head and the
    dense pooling head read the same `encode_hidden` states (the SPLADE
    parameter tree is a superset of the dense encoder's). Corpus side,
    `build` packs the impact CSR and the corpus embedding matrix from the
    same trunk.
    """

    def __init__(self, encoder: SpladeEncoder, *,
                 alpha_sparse: float = 0.5, alpha_dense: float = 0.5,
                 pool_k: int = 100, term_topm: int = 256,
                 build_batch: int = 512, reranker=None,
                 rerank_top_m: int = 20):
        self.encoder = encoder
        self.cfg = encoder.cfg
        self.alpha_sparse = float(alpha_sparse)
        self.alpha_dense = float(alpha_dense)
        self.pool_k = int(pool_k)
        self.term_topm = int(term_topm)
        self.build_batch = int(build_batch)
        self.reranker = reranker  # models.cross_encoder.CrossEncoderReranker
        self.rerank_top_m = int(rerank_top_m)
        self.index: Optional[SpladeDeviceIndex] = None
        self.texts: List[str] = []
        self._dev = None
        self._emb = None  # [N, D] f32 L2-normalized corpus embeddings

    def _featurized(self, texts: List[str]):
        ids, mask = self.encoder.host_featurize(texts)
        return (to_device(ids, self.encoder.device),
                to_device(mask, self.encoder.device))

    @torch.no_grad()
    def build(self, texts: Sequence[str]) -> None:
        texts = list(texts)
        self.texts = texts
        enc = self.encoder
        N, Bb, K = len(texts), self.build_batch, self.cfg.doc_top_terms
        all_ids = np.full((N, K), -1, dtype=np.int32)
        all_w = np.zeros((N, K), dtype=np.float32)
        embs = np.zeros((N, self.cfg.encoder.d_model), dtype=np.float32)
        for start in range(0, N, Bb):
            chunk = texts[start:start + Bb]
            n = len(chunk)
            ids, mask = self._featurized(chunk + [""] * (Bb - n))
            h = encode_hidden(enc.params, ids, mask, self.cfg.encoder)
            t_ids, t_w = sparsify_topk(
                splade_from_hidden(enc.params, h, mask, self.cfg, ids), K)
            all_ids[start:start + n] = t_ids[:n].cpu().numpy()
            all_w[start:start + n] = t_w[:n].cpu().numpy()
            embs[start:start + n] = pool_normalize(h, mask)[:n].cpu().numpy()
        self.index = SpladeDeviceIndex.from_expansions(
            all_ids, all_w, self.cfg.vocab_size)
        self._dev = _posting_tensors(self.index, enc.device)
        self._emb = to_device(embs, enc.device)

    @torch.no_grad()
    def _program(self, tok_ids, mask, top_k: int):
        n_docs = self.index.n_docs
        P = min(self.pool_k, n_docs)
        cfg, params = self.cfg, self.encoder.params

        def minmax(x, valid):
            big = torch.tensor(1e30, device=x.device)
            mn = torch.where(valid, x, big).amin(dim=1, keepdim=True)
            mx = torch.where(valid, x, -big).amax(dim=1, keepdim=True)
            return torch.where(valid,
                               (x - mn) / torch.clamp(mx - mn, min=1e-9),
                               torch.zeros_like(x))

        h = encode_hidden(params, tok_ids, mask, cfg.encoder)
        w = splade_from_hidden(params, h, mask, cfg, tok_ids)
        t_ids, t_w = sparsify_topk(w, cfg.query_top_terms)
        B, T = t_ids.shape
        sp_s, sp_i = bm25_topk_sorted(
            t_ids.reshape(B, 1, T), *self._dev, n_docs=n_docs,
            term_topm=min(self.term_topm, n_docs), pool_k=P,
            term_weights=t_w.reshape(B, 1, T))
        valid = sp_i >= 0
        q = pool_normalize(h, mask)  # [B, D]
        rows = torch.where(valid, sp_i, torch.zeros_like(sp_i)).long()
        cos = torch.einsum("bd,bpd->bp", q, self._emb[rows])
        fused = (self.alpha_sparse * minmax(sp_s, valid)
                 + self.alpha_dense * minmax(cos, valid))
        fused = torch.where(valid, fused,
                            torch.full_like(fused, float("-inf")))
        top_s, pos = stable_topk(fused, min(top_k, fused.shape[1]), dim=1)
        top_i = torch.gather(sp_i, 1, pos)
        finite = torch.isfinite(top_s)
        return (torch.where(finite, top_i, torch.full_like(top_i, -1)),
                torch.where(finite, top_s, torch.zeros_like(top_s)))

    def query_batch(self, queries: Sequence[str], top_k: int = 10
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [B, top_k] int32, fused scores [B, top_k]); when a
        reranker is attached, the top `rerank_top_m` of each row are
        re-ordered by cross-encoder score (one [B*M, L] device batch)."""
        if self.index is None:
            raise RuntimeError("SpladeDenseHybrid.build() first")
        queries = list(queries)
        ids, scores = self._program(*self._featurized(queries), top_k)
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        if self.reranker is not None:
            m = min(self.rerank_top_m, ids.shape[1])
            cand_texts = [[self.texts[i] if i >= 0 else "" for i in row[:m]]
                          for row in ids]
            order = np.asarray(self.reranker.rerank_batch(queries,
                                                          cand_texts),
                               dtype=np.int64)
            ids[:, :m] = np.take_along_axis(ids[:, :m], order, axis=1)
            scores[:, :m] = np.take_along_axis(scores[:, :m], order, axis=1)
        return ids, scores
