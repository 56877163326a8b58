"""BM25 CSR postings on the host, uploaded as torch tensors.

Port of the host half of ``a_modular_rag_framework_tpu/ops/bm25.py``
(`Bm25DeviceIndex`): the same fields, the same contribution-sorted
postings, the same doc-major views, and `device_tensors` returning the
same keys as the JAX `device_arrays`.

  idf(t)   = ln((N - df + 0.5) / (df + 0.5) + 1)
  c(t, d)  = idf(t) * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl/avgdl))
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._host import to_device
from ..models.hash_embed import phrase_augment, tokenize
from ..native import binding as _native


@dataclass(eq=False)
class Bm25Index:
    """CSR postings + stats as host numpy arrays.

    doc_ids int32 [P], tfs f32 [P], row_ptr int32 [V+1], df f32 [V],
    doc_lens f32 [N], vocab term -> id, scores f32 [P] (per-posting
    contribution; postings within a term sorted by it, descending)."""

    doc_ids: np.ndarray
    tfs: np.ndarray
    row_ptr: np.ndarray
    df: np.ndarray
    doc_lens: np.ndarray
    vocab: Dict[str, int]
    k1: float = 1.5
    b: float = 0.75
    scores: Optional[np.ndarray] = None

    @property
    def n_docs(self) -> int:
        return int(self.doc_lens.shape[0])

    @property
    def avgdl(self) -> float:
        return float(self.doc_lens.mean()) if self.n_docs else 0.0

    # ---- construction ----

    @classmethod
    def build(cls, texts: Sequence[str], k1: float = 1.5, b: float = 0.75,
              phrase_tokens: bool = False) -> "Bm25Index":
        """Native C++ streaming build when its library builds, else the
        Python build. Phrase tokens are appended by a Python pre-pass
        (`phrase_augment`) on both paths: the same token stream as the
        JAX builder's in-loop augmentation."""
        if phrase_tokens:
            texts = [phrase_augment(t) for t in texts]
        out = _native.bm25_build_native(list(texts), k1=k1, b=b)
        if out is None:
            return cls.build_python(texts, k1=k1, b=b)
        return cls(doc_ids=out["doc_ids"], tfs=out["tfs"],
                   row_ptr=out["row_ptr"], df=out["df"],
                   doc_lens=out["doc_lens"], vocab=out["vocab"],
                   k1=k1, b=b, scores=out["scores"])

    @classmethod
    def build_python(cls, texts: Sequence[str], k1: float = 1.5,
                     b: float = 0.75) -> "Bm25Index":
        vocab: Dict[str, int] = {}
        postings: List[Dict[int, int]] = []  # term id -> {doc: tf}
        doc_lens = np.zeros(len(texts), dtype=np.float32)
        for di, text in enumerate(texts):
            toks = tokenize(text)
            doc_lens[di] = len(toks)
            for t in toks:
                tid = vocab.setdefault(t, len(vocab))
                if tid == len(postings):
                    postings.append({})
                postings[tid][di] = postings[tid].get(di, 0) + 1
        V = len(vocab)
        df = np.array([len(p) for p in postings], dtype=np.float32)
        row_ptr = np.zeros(V + 1, dtype=np.int32)
        np.cumsum([len(p) for p in postings], out=row_ptr[1:])
        P = int(row_ptr[-1])
        doc_ids = np.zeros(P, dtype=np.int32)
        tfs = np.zeros(P, dtype=np.float32)
        scores = np.zeros(P, dtype=np.float32)
        n_total = float(len(texts))
        avgdl = (float(doc_lens.mean()) if len(texts) else 1.0) or 1.0
        for tid, p in enumerate(postings):
            s = row_ptr[tid]
            idf = np.log((n_total - df[tid] + 0.5) / (df[tid] + 0.5) + 1.0)
            items = []
            for di, tf in p.items():
                denom = tf + k1 * (1.0 - b + b * doc_lens[di] / avgdl)
                items.append((idf * tf * (k1 + 1.0) / (denom or 1.0), di, tf))
            # contribution-descending, doc-ascending tiebreak
            items.sort(key=lambda x: (-x[0], x[1]))
            for j, (c, di, tf) in enumerate(items):
                doc_ids[s + j] = di
                tfs[s + j] = tf
                scores[s + j] = c
        return cls(doc_ids=doc_ids, tfs=tfs, row_ptr=row_ptr, df=df,
                   doc_lens=doc_lens, vocab=vocab, k1=k1, b=b, scores=scores)

    # ---- derived views ----

    def ensure_scores(self) -> np.ndarray:
        """(Re)compute contributions for indexes loaded without them;
        posting order is kept as saved."""
        if self.scores is not None:
            return self.scores
        n_total = float(self.n_docs)
        avgdl = self.avgdl or 1.0
        idf = np.log((n_total - self.df + 0.5) / (self.df + 0.5) + 1.0)
        term_of_posting = np.repeat(
            np.arange(len(self.df), dtype=np.int64),
            np.diff(self.row_ptr).astype(np.int64))
        tf = np.asarray(self.tfs, dtype=np.float32)
        dl = np.asarray(self.doc_lens)[np.asarray(self.doc_ids)]
        denom = tf + self.k1 * (1.0 - self.b + self.b * dl / avgdl)
        self.scores = (idf[term_of_posting] * tf * (self.k1 + 1.0) /
                       np.where(denom > 0, denom, 1.0)).astype(np.float32)
        return self.scores

    def doc_major(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Doc-major CSR view: (doc_terms [P], doc_scores [P], doc_ptr [N+1])."""
        cached = getattr(self, "_doc_major", None)
        if cached is not None:
            return cached
        scores = self.ensure_scores()
        term_of_posting = np.repeat(
            np.arange(len(self.df), dtype=np.int32),
            np.diff(self.row_ptr).astype(np.int64))
        doc_arr = np.asarray(self.doc_ids)
        order = np.argsort(doc_arr, kind="stable")
        counts = np.bincount(doc_arr, minlength=self.n_docs)
        doc_ptr = np.zeros(self.n_docs + 1, dtype=np.int32)
        np.cumsum(counts, out=doc_ptr[1:])
        self._doc_major = (term_of_posting[order].astype(np.int32),
                           np.asarray(scores)[order].astype(np.float32),
                           doc_ptr)
        return self._doc_major

    def doc_major_padded(self, doc_cap: int = 64
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-stride doc-major view: (terms [N, D] int32 -2-padded,
        scores [N, D] f32). Docs with more than ``doc_cap`` distinct terms
        keep their highest-contribution terms (stable order)."""
        cached = getattr(self, "_dmp_cache", None)
        if cached and cached[0] == doc_cap:
            return cached[1], cached[2]
        doc_terms, doc_scores, doc_ptr = self.doc_major()
        N = self.n_docs
        terms = np.full((N, doc_cap), -2, dtype=np.int32)
        scores = np.zeros((N, doc_cap), dtype=np.float32)
        lengths = np.diff(doc_ptr).astype(np.int64)
        # rows that fit are copied in one vectorized scatter ...
        fits = np.repeat(lengths <= doc_cap, lengths)
        row = np.repeat(np.arange(N, dtype=np.int64), lengths)
        col = np.arange(doc_terms.shape[0], dtype=np.int64) - np.repeat(
            doc_ptr[:-1].astype(np.int64), lengths)
        terms[row[fits], col[fits]] = doc_terms[fits]
        scores[row[fits], col[fits]] = doc_scores[fits]
        # ... the rare longer rows keep their top doc_cap contributions
        for d in np.nonzero(lengths > doc_cap)[0]:
            s, e = int(doc_ptr[d]), int(doc_ptr[d + 1])
            order = np.argsort(-doc_scores[s:e], kind="stable")[:doc_cap]
            terms[d] = doc_terms[s:e][order]
            scores[d] = doc_scores[s:e][order]
        self._dmp_cache = (doc_cap, terms, scores)
        return terms, scores

    def device_tensors(self, device, doc_cap: int = 64
                       ) -> Dict[str, torch.Tensor]:
        """The same keys as the JAX ``device_arrays``, as tensors on
        ``device``. ``posting_packed`` is an [P, 2] int32 of (doc id,
        f32 score bit pattern), kept when it is at most 256 MB."""
        dmp_terms, dmp_scores = self.doc_major_padded(doc_cap)

        def up(a):
            return to_device(a, device)

        out = {
            "doc_ids": up(self.doc_ids),
            "tfs": up(self.tfs),
            "row_ptr": up(self.row_ptr),
            "df": up(self.df),
            "doc_lens": up(self.doc_lens),
            "scores": up(self.ensure_scores()),
            "doc_terms_padded": up(dmp_terms),
            "doc_scores_padded": up(dmp_scores),
        }
        if self.doc_ids.size * 8 <= (256 << 20):
            out["posting_packed"] = up(np.stack(
                [np.asarray(self.doc_ids, dtype=np.int32),
                 np.asarray(self.ensure_scores(),
                            dtype=np.float32).view(np.int32)], axis=1))
        return out
