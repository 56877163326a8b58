"""Host-side query preparation (copies of the helpers in
``a_modular_rag_framework_tpu/engine/query_engine.py``, whose module
imports jax): batch bucketing, idf-guided query pruning, BM25 term-id
encoding, variant padding and term-bucket trimming. A test holds each
equal to its original."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.hash_embed import phrase_augment, tokenize
from ..utils.textspan import capitalized_runs


def pick_bucket(buckets: Sequence[int], b: int) -> int:
    for s in buckets:
        if b <= s:
            return s
    return b


def build_high_df_terms(bm25, ratio: float, n_docs: int) -> Optional[set]:
    """Tokens whose document frequency exceeds ratio * n_docs; None when
    pruning is off."""
    if not ratio or not n_docs:
        return None
    df = np.asarray(bm25.df)
    cutoff = ratio * n_docs
    return {t for t, i in bm25.vocab.items() if df[i] > cutoff}


def prune_query(q: str, high_df_terms: Optional[set]) -> str:
    """Drop high-df tokens (falling back to the original when all drop);
    phrase pseudo-tokens are built from the capitalized runs BEFORE the
    lowercasing re-join would hide them."""
    if not high_df_terms or not q:
        return q
    kept = [t for t in tokenize(q) if t not in high_df_terms]
    if not q.islower():
        for r in capitalized_runs(q):
            if " " in r:
                p = "00".join(tokenize(r))
                if p not in high_df_terms:
                    kept.append(p)
    return " ".join(kept) if kept else q


def encode_query_term_ids(variants: Sequence[Sequence[str]], E: int, T: int,
                          vocab: Dict[str, int],
                          native_vocab=None) -> np.ndarray:
    """[B, E, T] int32 BM25 term ids (-1 padded), phrase-augmented;
    native lookup when available."""
    B = len(variants)
    if native_vocab is not None:
        flat: List[str] = []
        for vs in variants:
            vs = list(vs)[:E]
            flat.extend([phrase_augment(v) if v else "" for v in vs]
                        + [""] * (E - len(vs)))
        return native_vocab.lookup_batch(flat, T).reshape(B, E, T)
    term_ids = np.full((B, E, T), -1, dtype=np.int32)
    for b, vs in enumerate(variants):
        for e, q in enumerate(list(vs)[:E]):
            tids = [vocab[t] for t in tokenize(phrase_augment(q))
                    if t in vocab][:T]
            term_ids[b, e, : len(tids)] = tids
    return term_ids


def prepare_query_variants(
    queries: Sequence[str],
    expansions: Optional[Sequence[Sequence[str]]],
    B: int,
    max_variants: int,
) -> Tuple[List[List[str]], int]:
    """Pad the batch to B, cap variants, and pick the power-of-two variant
    bucket E actually needed."""
    variants: List[List[str]] = []
    for i in range(B):
        if i < len(queries):
            v = [queries[i]] + list(expansions[i] if expansions else [])
        else:
            v = [""]
        variants.append(v[:max_variants])
    e_needed = max(len(v) for v in variants)
    E = 1
    while E < e_needed:
        E *= 2
    return variants, min(E, max_variants)


def trim_term_bucket(term_ids: np.ndarray, max_terms: int) -> np.ndarray:
    """Trim [B, E, T] to the power-of-two T bucket actually used (>= 8)."""
    used_t = int((term_ids >= 0).any(axis=(0, 1)).nonzero()[0].max() + 1) \
        if (term_ids >= 0).any() else 1
    T_eff = 8
    while T_eff < used_t:
        T_eff *= 2
    return term_ids[:, :, : min(T_eff, max_terms)]
