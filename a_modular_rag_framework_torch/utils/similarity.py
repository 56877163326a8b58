"""Similarity utilities (host numpy).

The port's copy of ``a_modular_rag_framework_tpu/utils/similarity.py``:
scalar helpers (difflib ratio, cosine, embedding similarity with fallbacks),
`cosine_matrix` (one normalized matmul for all pairs) and `mmr_diversify`
(greedy MMR with a vectorized redundancy term).
"""
from __future__ import annotations

import math
from difflib import SequenceMatcher
from typing import Callable, List, Optional, Tuple

import numpy as np


def compute_similarity_score(a: str, b: str) -> float:
    """Character-level ratio fallback."""
    return SequenceMatcher(None, a or "", b or "").ratio()


def cosine(u: List[float], v: List[float]) -> float:
    if not u or not v:
        return 0.0
    du = math.sqrt(sum(x * x for x in u))
    dv = math.sqrt(sum(y * y for y in v))
    if du == 0 or dv == 0:
        return 0.0
    return sum(x * y for x, y in zip(u, v)) / (du * dv)


def embed_sim(
    a: str,
    b: str,
    embed: Optional[Callable[[str], List[float]]] = None,
    va: Optional[List[float]] = None,
    vb: Optional[List[float]] = None,
) -> float:
    """Embedding similarity with fallback chain: vectors -> embed() -> difflib."""
    if va is None and embed:
        va = embed(a or "")
    if vb is None and embed:
        vb = embed(b or "")
    if va is None or vb is None:
        return compute_similarity_score(a, b)
    return cosine(list(va), list(vb))


def cosine_matrix(E: np.ndarray) -> np.ndarray:
    """All-pairs cosine as one normalized matmul E_n @ E_n.T (host numpy)."""
    E = np.asarray(E, dtype=np.float32)
    norms = np.linalg.norm(E, axis=1, keepdims=True)
    En = E / np.maximum(norms, 1e-9)
    return En @ En.T


def mmr_diversify(
    items: List[Tuple[str, float, Optional[List[float]]]],
    *,
    top_k: int = 20,
    lambda_weight: float = 0.7,
) -> List[Tuple[str, float, Optional[List[float]]]]:
    """Greedy MMR over (id, score, vec) items; vectorized redundancy term."""
    if not items:
        return []
    n = len(items)
    have_vecs = all(it[2] is not None for it in items)
    if have_vecs:
        S = cosine_matrix(np.array([it[2] for it in items], dtype=np.float32))
    else:
        S = np.zeros((n, n), dtype=np.float32)
    scores = np.array([it[1] for it in items], dtype=np.float32)

    selected: List[int] = []
    remaining = set(range(n))
    max_sim = np.zeros(n, dtype=np.float32)
    while remaining and len(selected) < top_k:
        cand = np.array(sorted(remaining))
        if selected:
            vals = lambda_weight * scores[cand] - (1 - lambda_weight) * max_sim[cand]
        else:
            vals = scores[cand]
        pick = int(cand[int(np.argmax(vals))])
        selected.append(pick)
        remaining.discard(pick)
        max_sim = np.maximum(max_sim, S[pick])
    return [items[i] for i in selected]
