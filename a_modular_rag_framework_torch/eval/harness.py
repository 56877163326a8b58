"""Evaluation harness: retrieval Recall@k/MRR/QPS and end-to-end EM/F1.

The port's copy of ``a_modular_rag_framework_tpu/eval/harness.py``; its
lazy ``multihop`` import resolves to the port's
``modules/retrieval/multihop.py``.

The measurement counterpart of BASELINE.md: `evaluate_retrieval` drives the
query engine over a labeled sample set (supporting facts as gold sentence
ids), and `evaluate_system` runs the full agent pipeline and scores answers.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .metrics import contains_match, exact_match, f1_score, mrr, recall_at_k


def gold_hit_ids(sample: Dict[str, Any]) -> List[str]:
    """Supporting facts -> canonical ``sent::<title>::<sid>`` hit ids."""
    return [f"sent::{t}::{sid}" for t, sid in sample.get("supporting_facts", [])]


def evaluate_retrieval(
    engine,
    samples: Sequence[Dict[str, Any]],
    *,
    k: int = 10,
    batch_size: int = 64,
    expansions: Optional[Sequence[Sequence[str]]] = None,
) -> Dict[str, Any]:
    """Batch the questions through the engine; report Recall@k, MRR, QPS."""
    questions = [s["question"] for s in samples]
    recalls: List[float] = []
    rrs: List[float] = []
    t_total = 0.0
    n_q = 0

    for start in range(0, len(questions), batch_size):
        batch = questions[start : start + batch_size]
        exp = (list(expansions[start : start + batch_size])
               if expansions is not None else None)
        t0 = time.time()
        result = engine.query_batch(batch, expansions=exp, top_k=max(k, 10))
        t_total += time.time() - t0
        n_q += len(batch)
        ids = np.asarray(result.hits.ids)
        for row, sample in enumerate(samples[start : start + batch_size]):
            retrieved = [engine.index.corpus.hit_id(int(i))
                         for i in ids[row] if i >= 0]
            gold = gold_hit_ids(sample)
            recalls.append(recall_at_k(retrieved, gold, k))
            rrs.append(mrr(retrieved, gold))

    return {
        "n": n_q,
        f"recall_at_{k}": float(np.mean(recalls)) if recalls else 0.0,
        "mrr": float(np.mean(rrs)) if rrs else 0.0,
        "total_sec": round(t_total, 4),
        "qps": round(n_q / t_total, 2) if t_total > 0 else 0.0,
    }


def evaluate_dense(
    engine,
    samples: Sequence[Dict[str, Any]],
    *,
    k: int = 10,
    hop1_inspect: int = 20,
    hop_decay: float = 0.5,
) -> Dict[str, Any]:
    """Dense-channel-only quality over the engine's corpus embeddings
    (`query_dense_batch`): 1-shot recall@k (structurally capped at ~0.5 on
    2-hop questions — hop-2 gold shares no text with the question), the
    hop-1 half alone, and the dense 2-HOP recipe (hop-1 dense -> bridge
    extraction -> hop-2 dense -> reserve-aware decayed merge — the dense
    analogue of the engine's iterative quality mode)."""
    from ..modules.retrieval.multihop import (
        bridge_entities,
        hop2_queries_for,
    )

    qs = [s["question"] for s in samples]
    r1 = engine.query_dense_batch(qs, top_k=hop1_inspect)
    i1 = np.asarray(r1.hits.ids)
    s1 = np.asarray(r1.hits.scores)

    corpus = engine.index.corpus
    known_titles = {d.get("title") for d in corpus.docs}
    known_titles.discard(None)
    docs = corpus.docs
    hop2_qs = []
    for b, q in enumerate(qs):
        texts = [docs[int(i)].get("text", "") for i in i1[b] if i >= 0]
        bridges = bridge_entities(q, texts, max_entities=1,
                                  known_titles=known_titles)
        hop2_qs.append(hop2_queries_for(q, bridges)[0] if bridges else "")
    r2 = engine.query_dense_batch(hop2_qs, top_k=hop1_inspect)
    i2 = np.asarray(r2.hits.ids)
    s2 = np.asarray(r2.hits.scores)

    rec1, rec1_hop1, rec2h, rr2h = [], [], [], []
    reserve = max(2, k // 4)
    for b, sample in enumerate(samples):
        gold = gold_hit_ids(sample)
        got1 = [corpus.hit_id(int(i)) for i in i1[b][:k] if i >= 0]
        rec1.append(recall_at_k(got1, gold, k))
        sf = sample.get("supporting_facts") or []
        if sf:
            rec1_hop1.append(recall_at_k(
                got1, [f"sent::{sf[0][0]}::{sf[0][1]}"], k))
        h1 = [(int(i), float(sc)) for i, sc in zip(i1[b], s1[b]) if i >= 0]
        h1_ids = {i for i, _ in h1[:k]}
        h2 = ([(int(i), float(sc) * hop_decay) for i, sc in
               zip(i2[b], s2[b]) if i >= 0 and int(i) not in h1_ids]
              if hop2_qs[b] else [])
        r_n = min(reserve, len(h2))
        ranked = sorted(h1[:k - r_n] + h2[:r_n], key=lambda kv: -kv[1])[:k]
        got2 = [corpus.hit_id(i) for i, _ in ranked]
        rec2h.append(recall_at_k(got2, gold, k))
        rr2h.append(mrr(got2, gold))
    return {
        f"recall_at_{k}": round(float(np.mean(rec1)), 4),
        "hop1_recall": round(float(np.mean(rec1_hop1)), 4)
        if rec1_hop1 else None,
        f"two_hop_recall_at_{k}": round(float(np.mean(rec2h)), 4),
        "two_hop_mrr": round(float(np.mean(rr2h)), 4),
    }


def evaluate_system(
    answer_fn,
    samples: Sequence[Dict[str, Any]],
    *,
    mode: str = "full",
) -> Dict[str, Any]:
    """Run the full pipeline per sample and score answers (EM / relaxed EM /
    F1) plus verifier verdict distribution."""
    ems: List[float] = []
    cms: List[float] = []
    f1s: List[float] = []
    verdicts: Dict[str, int] = {}
    records: List[Dict[str, Any]] = []
    t0 = time.time()
    for s in samples:
        res = answer_fn(s["question"], mode=mode)
        pred = ((res.get("reasoning") or {}).get("answer")) or ""
        gold = s.get("answer") or ""
        ems.append(exact_match(pred, gold))
        cms.append(contains_match(pred, gold))
        f1s.append(f1_score(pred, gold))
        verdict = str((res.get("verification") or {}).get("verdict"))
        verdicts[verdict] = verdicts.get(verdict, 0) + 1
        records.append({"id": s.get("_id"), "question": s["question"],
                        "gold": gold, "pred": pred, "verdict": verdict,
                        "retry_round": res.get("retry_round", 0)})
    total = time.time() - t0
    return {
        "n": len(samples),
        "em": float(np.mean(ems)) if ems else 0.0,
        "em_relaxed": float(np.mean(cms)) if cms else 0.0,
        "f1": float(np.mean(f1s)) if f1s else 0.0,
        "verdicts": verdicts,
        "total_sec": round(total, 2),
        "records": records,
    }
