"""Evaluation metrics: Recall@k, MRR, EM, F1.

The port's copy of ``a_modular_rag_framework_tpu/eval/metrics.py``.

The reference's own design review lists these as its unfilled P0 gap
(documents/System_Evaluation_01.pdf pp.6-7, per SURVEY.md §6); this module
closes it. Answer normalization follows the standard HotpotQA/SQuAD
convention (lowercase, strip articles + punctuation, squeeze whitespace).
"""
from __future__ import annotations

import re
import string
from collections import Counter
from typing import Iterable, List, Sequence, Set, Tuple


def normalize_answer(s: str) -> str:
    s = (s or "").lower()
    s = re.sub(r"\[[^\]]*\]", " ", s)  # strip inline citations
    s = "".join(ch if ch not in set(string.punctuation) else " " for ch in s)
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def exact_match(pred: str, gold: str) -> float:
    return float(normalize_answer(pred) == normalize_answer(gold))


def contains_match(pred: str, gold: str) -> float:
    """Relaxed EM: the normalized gold appears inside the normalized
    prediction (sentence-style answers citing evidence)."""
    g = normalize_answer(gold)
    return float(bool(g) and g in normalize_answer(pred))


def f1_score(pred: str, gold: str) -> float:
    p_toks = normalize_answer(pred).split()
    g_toks = normalize_answer(gold).split()
    if not p_toks or not g_toks:
        return float(p_toks == g_toks)
    common = Counter(p_toks) & Counter(g_toks)
    overlap = sum(common.values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(p_toks)
    recall = overlap / len(g_toks)
    return 2 * precision * recall / (precision + recall)


def recall_at_k(retrieved: Sequence[str], gold: Iterable[str], k: int) -> float:
    """Fraction of gold ids present in the top-k retrieved ids."""
    gold_set: Set[str] = set(gold)
    if not gold_set:
        return 0.0
    top = set(retrieved[:k])
    return len(gold_set & top) / len(gold_set)


def mrr(retrieved: Sequence[str], gold: Iterable[str]) -> float:
    """Reciprocal rank of the first gold id."""
    gold_set = set(gold)
    for i, r in enumerate(retrieved, 1):
        if r in gold_set:
            return 1.0 / i
    return 0.0
