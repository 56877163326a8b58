"""G1 semantic segmentation of context documents.

The port's copy of ``a_modular_rag_framework_tpu/modules/graph_construction/segmenter.py``.

Capability parity with the reference implementation's app/modules/graph_construction/
segmenter.py:5-56 — two strategies:

  - ``rule``: re-split each sentence on terminal punctuation;
  - ``embed``: merge adjacent sentences while their embedding cosine stays
    above a threshold. Unlike the reference's one-embed-call-per-sentence
    loop, the whole document is embedded as ONE device batch and the
    adjacent-pair cosines come from a single vectorized computation.
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

_SENT_SPLIT = re.compile(r"[。！？.!?]")


def simple_rule_split(text: str) -> List[str]:
    """Punctuation-based sentence split."""
    return [s.strip() for s in _SENT_SPLIT.split(text or "") if s.strip()]


def _merge_by_similarity(
    sents: Sequence[str],
    sims: np.ndarray,  # [len(sents)-1] adjacent-pair cosines
    threshold: float,
) -> List[str]:
    """Greedy merge: a boundary is cut where adjacent cosine < threshold
    (reference semantics: low similarity -> segment break)."""
    out: List[str] = []
    batch: List[str] = []
    for i, s in enumerate(sents):
        if batch and i - 1 < len(sims) and sims[i - 1] < threshold:
            out.append(" ".join(batch))
            batch = []
        batch.append(s)
    if batch:
        out.append(" ".join(batch))
    return out


def segment_context(
    ctx: Sequence[Tuple[str, List[str]]],
    *,
    strategy: str = "rule",
    embed_fn: Optional[Callable[[List[str]], np.ndarray]] = None,
    sim_threshold: float = 0.65,
) -> List[Tuple[str, List[str]]]:
    """Segment each (title, sentences) document.

    ``embed_fn`` is BATCHED: ``List[str] -> [n, d]`` array (the batched
    signature; wrap single-text embedders upstream).
    """
    out: List[Tuple[str, List[str]]] = []
    for title, sents in ctx:
        sents = list(sents)
        if strategy == "rule":
            new_sents: List[str] = []
            for s in sents:
                new_sents.extend(simple_rule_split(s))
        elif strategy == "embed" and embed_fn is not None and len(sents) > 1:
            emb = np.asarray(embed_fn(sents), dtype=np.float32)
            norms = np.linalg.norm(emb, axis=1)
            dots = np.sum(emb[:-1] * emb[1:], axis=1)
            sims = dots / np.maximum(norms[:-1] * norms[1:], 1e-9)
            new_sents = _merge_by_similarity(sents, sims, sim_threshold)
        else:
            new_sents = sents
        out.append((title, new_sents))
    return out
