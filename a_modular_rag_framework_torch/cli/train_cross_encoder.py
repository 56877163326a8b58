"""Train the cross-encoder reranker and export weights (port of
``a_modular_rag_framework_tpu/cli/train_cross_encoder.py``).

Listwise training on (question, [gold sentence + hard negatives]) lists
from a HotpotQA-style synthetic dataset: negatives are drawn from the SAME
sample's distractor context (template- and entity-colliding, the hard
case) padded with corpus-random sentences. Eval is on a disjoint seed: the
MRR / recall delta from reranking the hybrid engine's top-k.

  python -m a_modular_rag_framework_torch.cli.train_cross_encoder \
      --synthetic 512 --steps 300 --out data/cross_encoder.npz

The arguments, defaults, printed lines and report keys are the original's;
``--device`` (default ``cuda``) is added. Lists and batches are drawn with
``np.random.default_rng(seed)`` as there; the fresh parameters come from a
seeded ``torch.Generator``, not from JAX's PRNG.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Sequence, Tuple

import numpy as np


def build_lists(samples, m_cands: int, rng: np.random.Generator
                ) -> Tuple[List[str], List[List[str]], List[int]]:
    """One training list per supporting fact: the gold sentence + m-1
    negatives (same-sample distractor sentences first, corpus-random
    fill), gold at a random slot."""
    all_sents: List[str] = []
    for s in samples:
        for _, sents in s.get("context", []):
            all_sents.extend(sents)
    queries, lists, labels = [], [], []
    for s in samples:
        ctx = {t: sents for t, sents in s.get("context", [])}
        gold_set = set()
        for title, sid in s.get("supporting_facts", []):
            sents = ctx.get(title) or []
            if 0 <= sid < len(sents):
                gold_set.add(sents[sid])
        own_neg = [x for t, sents in s.get("context", []) for x in sents
                   if x not in gold_set]
        for g in gold_set:
            negs = list(rng.choice(own_neg, size=min(len(own_neg), m_cands - 1),
                                   replace=False)) if own_neg else []
            while len(negs) < m_cands - 1:
                cand = all_sents[int(rng.integers(len(all_sents)))]
                if cand not in gold_set:
                    negs.append(cand)
            slot = int(rng.integers(m_cands))
            cands = negs[:slot] + [g] + negs[slot:]
            queries.append(s["question"])
            lists.append(cands[:m_cands])
            labels.append(min(slot, m_cands - 1))
    return queries, lists, labels


def eval_rerank(samples, reranker, k: int = 10) -> dict:
    """Held-out end-to-end effect: build an index + engine over
    ``samples`` on the reranker's device, rerank its top-k with the
    cross-encoder, report recall@k / MRR before vs after."""
    from ..engine.query_engine import EngineConfig, TorchQueryEngine
    from ..eval.harness import gold_hit_ids
    from ..eval.metrics import mrr as mrr_fn
    from ..eval.metrics import recall_at_k
    from ..index.builder import build_packed_index
    from ..index.corpus import SentenceCorpus

    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus)
    B = 64
    engine = TorchQueryEngine(idx, device=reranker.device, config=EngineConfig(
        top_k=k, pool_k=200, graph_window=2, batch_buckets=(B,),
        query_df_ratio_max=0.05))
    out = {"recall_before": [], "recall_after": [],
           "mrr_before": [], "mrr_after": []}
    qs = [s["question"] for s in samples]
    for a in range(0, len(qs), B):
        chunk = samples[a:a + B]
        r = engine.query_batch([s["question"] for s in chunk], top_k=k)
        ids = np.asarray(r.hits.ids)
        texts = [[corpus.docs[int(i)].get("text", "") if i >= 0 else ""
                  for i in ids[row]] for row in range(len(chunk))]
        orders = reranker.rerank_batch([s["question"] for s in chunk], texts)
        for row, s in enumerate(chunk):
            got = [corpus.hit_id(int(i)) for i in ids[row] if i >= 0]
            gold = gold_hit_ids(s)
            out["recall_before"].append(recall_at_k(got, gold, k))
            out["mrr_before"].append(mrr_fn(got, gold))
            re_ids = [ids[row][j] for j in orders[row]]
            got2 = [corpus.hit_id(int(i)) for i in re_ids if i >= 0]
            out["recall_after"].append(recall_at_k(got2, gold, k))
            out["mrr_after"].append(mrr_fn(got2, gold))
    return {kk: round(float(np.mean(v)), 4) for kk, v in out.items()}


def main(argv: Sequence[str] | None = None) -> None:
    from .._host import upload_batch
    from ..core.dataset_loader import SyntheticHotpotQALoader
    from ..models.cross_encoder import (
        CrossEncoderConfig,
        CrossEncoderReranker,
        make_cross_train_step,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval_seed", type=int, default=101)
    ap.add_argument("--eval_samples", type=int, default=128)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--m_cands", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--subword_ngrams", type=int, default=8)
    ap.add_argument("--variety", action="store_true")
    ap.add_argument("--collide", action="store_true",
                    help="train on the colliding-entity distribution the "
                         "scale bench corpora sample (shared first/surname "
                         "tokens across hundreds of distractors)")
    ap.add_argument("--out", default="data/cross_encoder.npz")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains and is evaluated "
                         "('cuda', 'cuda:i' or 'cpu')")
    args = ap.parse_args(argv)

    cfg = CrossEncoderConfig(subword_ngrams=args.subword_ngrams)
    loader_kw = {"variety": args.variety}
    if args.collide:
        loader_kw.update(collide_entities=True, n_distractors=8)
    samples = SyntheticHotpotQALoader(
        {"count": args.synthetic, "seed": args.seed, **loader_kw}).load()
    rng = np.random.default_rng(args.seed)
    queries, lists, labels = build_lists(samples, args.m_cands, rng)
    print(f"training lists: {len(queries)} (M={args.m_cands})", flush=True)

    reranker = CrossEncoderReranker(cfg, seed=args.seed, device=args.device)
    init_state, step = make_cross_train_step(cfg, args.lr)
    params, opt_state = reranker.params, init_state(reranker.params)
    order = rng.permutation(len(queries))
    t0 = time.time()
    for it in range(args.steps):
        take = order[(it * args.batch) % len(order):][: args.batch]
        if len(take) < args.batch:
            take = np.concatenate([take, order[: args.batch - len(take)]])
        batch = upload_batch(CrossEncoderReranker.make_listwise_batch(
            [queries[i] for i in take], [lists[i] for i in take],
            [labels[i] for i in take], cfg), reranker.device)
        params, opt_state, metrics = step(params, opt_state, batch)
        if (it + 1) % 50 == 0 or it == 0:
            print(f"step {it + 1}: loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f}", flush=True)
    print(f"trained in {time.time() - t0:.1f}s", flush=True)
    reranker.params = params
    reranker.save(args.out)
    print(f"saved {args.out}")

    heldout = SyntheticHotpotQALoader(
        {"count": args.eval_samples, "seed": args.eval_seed,
         **loader_kw}).load()
    report = eval_rerank(heldout, reranker)
    print(json.dumps({"heldout_seed": args.eval_seed, **report}))


if __name__ == "__main__":
    main()
