"""The comparison that decides ``correct``: the answers the window
produced, judged by the plain reference (``reference/<name>.py`` of the
configuration), after the window closed and the program's state was freed.

A sample of the answered questions is drawn from the seed. For each, the
reference scores every row the question can reach and the program's hits
are read against it:

- ``*_rank_gap``: the widest gap by which a hit's reference score lies
  below the reference's own best at that place (hybrid: below its
  ``top_k``-th fused score, since the ``top_k`` are chosen by fused score
  and then re-ordered; dense: below its j-th best cosine, hit j). A hit
  the reference cannot reach, or a missing hit, reads 1 (both scores lie
  in [0, 1]). Rows tied in the reference's score read 0, whichever the
  program chose.
- ``*_score_err``: the largest difference between a hit's score as the
  program reports it and the reference's score of the same row (hybrid:
  the order score; dense: the cosine).

The control is the same reference computed in the nearest precision below
the configuration's, put in the program's place (the ``control``
argument), and judged by the same two numbers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .seeds import seed_rng


def draw_sample(results: Sequence[tuple], n: int, seed: int
                ) -> List[Tuple[int, int]]:
    """(call, row) pairs of ``n`` answered questions drawn from the seed."""
    total = sum(len(r[0]) for r in results)
    picks = np.sort(seed_rng(seed, 2).choice(total, size=min(n, total),
                                             replace=False))
    out, call, base = [], 0, 0
    for p in picks.tolist():
        while p >= base + len(results[call][0]):
            base += len(results[call][0])
            call += 1
        out.append((call, p - base))
    return out


def quality(row_of: Dict[tuple, int], samples: Sequence[dict],
            results: Sequence[tuple], sample: Sequence[Tuple[int, int]],
            k: int) -> Dict[str, float]:
    """recall@k and MRR of the sampled answers against the generator's
    supporting facts (earlier lines of the run only)."""
    rec, rr = [], []
    for call, row in sample:
        qidx, ids, _ = results[call]
        s = samples[int(qidx[row])]
        gold = {row_of.get((t, sid)) for t, sid in s["supporting_facts"]}
        hits = [int(h) for h in ids[row][:k]]
        rec.append(sum(g in hits for g in gold) / max(len(gold), 1))
        first = [i for i, h in enumerate(hits) if h in gold]
        rr.append(1.0 / (first[0] + 1) if first else 0.0)
    return {"recall_at_k": float(np.mean(rec)) if rec else 0.0,
            "mrr": float(np.mean(rr)) if rr else 0.0}


# ---------------- hybrid ----------------

def hybrid_widths(ref, questions: Sequence[str], results: Sequence[tuple],
                  calls: Sequence[int]) -> Dict[int, int]:
    """The term width of each sampled call's batch."""
    counts = np.array([len(ref.terms(ref.prune(q))) for q in questions])
    return {c: ref.term_width(int(counts[results[c][0]].max()))
            for c in set(calls)}


def judge_hybrid(truth: dict, ids: Sequence[int], scores: Sequence[float],
                 k: int) -> Tuple[float, float]:
    """(rank gap, score error) of one answer against the reference."""
    fused, order = truth["fused"], truth["order"]
    best = sorted(fused.values(), reverse=True)
    want = min(k, len(best))
    kth = best[want - 1] if want else 0.0
    valid = [(int(h), float(s)) for h, s in zip(ids, scores) if h >= 0]
    gap = err = 0.0
    if len(valid) != want:
        return 1.0, 1.0
    for h, s in valid:
        if h not in fused:
            return 1.0, 1.0
        gap = max(gap, float(kth) - float(fused[h]))
        err = max(err, abs(s - float(order[h])))
    return gap, err


def check_hybrid(ref, questions: Sequence[str], results: Sequence[tuple],
                 sample: Sequence[Tuple[int, int]], k: int,
                 control: Optional[str] = None) -> Dict[str, float]:
    """The two numbers over the sample; with ``control`` (a rounding name
    of the reference) the control's answers stand in for the program's."""
    widths = hybrid_widths(ref, questions, results, [c for c, _ in sample])
    gap = err = 0.0
    rnd = ref.ROUNDING[control] if control else None
    for call, row in sample:
        qidx, ids, scores = results[call]
        q = questions[int(qidx[row])]
        truth = ref.hybrid(q, widths[call])
        if rnd is not None:
            stand_in = ref.hybrid(q, widths[call], rnd=rnd)
            ids_r, scores_r = stand_in["hits"], stand_in["scores"]
        else:
            ids_r, scores_r = ids[row], scores[row]
        g, e = judge_hybrid(truth, ids_r, scores_r, k)
        gap, err = max(gap, g), max(err, e)
    return {"hybrid_rank_gap": gap, "hybrid_score_err": err}


# ---------------- dense ----------------

def check_dense(ref, samples: Sequence[dict], config: dict,
                params: Optional[dict], results: Sequence[tuple],
                sample: Sequence[Tuple[int, int]], k: int, device,
                control: Optional[str] = None,
                cache: Optional[dict] = None) -> Dict[str, float]:
    """Rows and sampled questions embedded by the reference's own copy of
    the configuration's encoder, whichever builder makes it (the
    reference's ``embed_texts`` over the builder's parameter tree, with
    operands in the block's ``dtype``; without an ``encoder`` block, the
    hash encoder of ``index.embed_dim``), exact float32 top-k. Controls: ``bfloat16`` scores bfloat16-rounded queries
    (the step below the float32-faithful scores); ``float8_e4m3fn`` embeds
    rows and queries with the trunk's operands in fp8 (the step below its
    bfloat16). The control's top-k stands in for the program's. ``cache``
    keeps the reference's embeddings between calls."""
    cache = {} if cache is None else cache
    enc = config.get("encoder")
    rows = [t for _, _, t in ref.flatten(samples)]
    qtexts = [samples[int(results[c][0][r])]["question"] for c, r in sample]

    def embed(dtype):
        if dtype not in cache:
            if enc is None:
                dim = int(config["index"]["embed_dim"])
                cache[dtype] = (
                    torch.from_numpy(ref.hash_matrix(rows, dim, stored=True))
                    .to(device, torch.bfloat16),
                    torch.from_numpy(ref.hash_matrix(qtexts, dim)).to(device))
            else:
                cache[dtype] = (ref.store_bf16(ref.embed_texts(
                    params, rows, enc, device, dtype)),
                    ref.embed_texts(params, qtexts, enc, device, dtype))
        return cache[dtype]

    operand = getattr(torch, enc["dtype"]) if enc else torch.float32
    corpus, q = embed(operand)
    best_s, _ = ref.dense_scores(q, corpus, k)
    if control == "bfloat16":
        got, ids = ref.dense_scores(q, corpus, k, query_dtype=torch.bfloat16)
    elif control is not None:
        c_corpus, c_q = embed(getattr(torch, control))
        got, ids = ref.dense_scores(c_q, c_corpus, k)
    else:
        ids = torch.tensor(np.stack([results[c][1][r] for c, r in sample]),
                           device=device, dtype=torch.int64)
        got = torch.tensor(np.stack([results[c][2][r] for c, r in sample]),
                           device=device, dtype=torch.float32)
    if ids.shape[1] < k or bool((ids < 0).any()) or bool(
            (ids >= corpus.shape[0]).any()):
        return {"dense_rank_gap": 1.0, "dense_score_err": 1.0}
    hit = ref.row_scores(q, corpus, ids)
    gap = float((best_s - hit).clamp(min=0).max())
    err = float((got - hit).abs().max())
    return {"dense_rank_gap": gap, "dense_score_err": err}
