"""Train the SPLADE-style sparse expansion model and export weights (port
of ``a_modular_rag_framework_tpu/cli/train_splade.py``).

Same contrastive pair recipe as the dense encoder CLI (question,
supporting-sentence pairs, in-batch InfoNCE) plus the FLOPS sparsity
regularizer. After training, evaluates standalone sparse retrieval
(recall@10 / MRR) on a held-out corpus against the BM25 channel over the
identical sentences.

Checkpoint selection: half the InfoNCE positives are hop-2 supporting
sentences that share no tokens with the question (build_pairs emits one
pair per supporting fact). Ranking those top-1 is only achievable by
memorizing entity co-occurrences, so unconstrained training degrades the
idf-prior lexical floor on DISJOINT-entity corpora. The CLI therefore
evaluates on a VALIDATION corpus (seed+2, never reported) every
eval_every steps and ships the best checkpoint; the reported held-out
corpus (seed+1) stays untouched by selection. In-domain eval (training
corpus) is reported next to it: the deployment regime, where doc
expansions are computed over the indexed corpus the model saw at train
time.

Usage:
  python -m a_modular_rag_framework_torch.cli.train_splade \
      --synthetic 512 --steps 300 --eval_samples 128 --out data/splade.npz

The arguments, defaults, printed lines and report keys are the original's;
``--device`` (default ``cuda``) is added. Batches are drawn with
``np.random.default_rng(seed)`` as there; the fresh parameters come from a
seeded ``torch.Generator``, not from JAX's PRNG.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from .train_encoder import build_pairs


def _recall_mrr(ids_rows, gold_rows, k: int, recalls: List[float],
                mrrs: List[float]) -> None:
    """Append recall@k and the reciprocal rank of each row with gold."""
    for row, gold in enumerate(gold_rows):
        got = [int(i) for i in ids_rows[row] if i >= 0]
        if not gold:
            continue
        hits = sum(1 for g in got if g in gold)
        recalls.append(hits / min(len(gold), k))
        rr = 0.0
        for rank, g in enumerate(got):
            if g in gold:
                rr = 1.0 / (rank + 1)
                break
        mrrs.append(rr)


def _gold_rows(corpus, samples):
    by = corpus.row_by_title_sid()
    return [{by[(t, sid)] for t, sid in s.get("supporting_facts", [])
             if (t, sid) in by} for s in samples]


def eval_sparse(samples, retriever, k: int = 10) -> Dict[str, float]:
    """Recall@k / MRR of a standalone sparse retriever over the flat
    sentence corpus of ``samples`` (gold = supporting-fact sentences)."""
    from ..index.corpus import SentenceCorpus

    corpus = SentenceCorpus.from_hotpotqa(samples)
    retriever.build(corpus.texts())
    gold_rows = _gold_rows(corpus, samples)
    recalls, mrrs = [], []
    B = 64
    qs = [s["question"] for s in samples]
    for start in range(0, len(qs), B):
        chunk = qs[start:start + B]
        pad = B - len(chunk)
        ids, _ = retriever.query_batch(chunk + [""] * pad, top_k=k)
        _recall_mrr(ids, gold_rows[start:start + len(chunk)], k, recalls,
                    mrrs)
    return {"recall_at_10": float(np.mean(recalls)) if recalls else 0.0,
            "mrr": float(np.mean(mrrs)) if mrrs else 0.0}


def eval_bm25(samples, k: int = 10, *, device="cuda") -> Dict[str, float]:
    """BM25 over the same sentences (the lexical sparse baseline). The
    query terms come from `engine.host_prep.encode_query_term_ids` with one
    variant per query: the index is built without phrase tokens, so the
    phrase pseudo-words that helper appends are not in the vocabulary and
    the ids are the original's ``encode_query_terms``."""
    import torch

    from .._host import require_device, to_device
    from ..engine.host_prep import encode_query_term_ids
    from ..index.bm25 import Bm25Index
    from ..index.corpus import SentenceCorpus
    from ..ops.bm25 import bm25_topk_sorted

    device = require_device(device)
    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = Bm25Index.build(corpus.texts())
    postings = (to_device(idx.doc_ids, device),
                to_device(idx.ensure_scores(), device),
                to_device(idx.row_ptr, device))
    gold_rows = _gold_rows(corpus, samples)
    recalls, mrrs = [], []
    qs = [s["question"] for s in samples]
    B = 64
    for start in range(0, len(qs), B):
        chunk = qs[start:start + B]
        pad = B - len(chunk)
        t = encode_query_term_ids([[q] for q in chunk + [""] * pad], 1, 16,
                                  idx.vocab)
        with torch.no_grad():
            _, ids = bm25_topk_sorted(
                to_device(t, device), *postings, n_docs=idx.n_docs,
                term_topm=min(256, idx.n_docs), pool_k=k)
        _recall_mrr(ids.cpu().numpy(), gold_rows[start:start + len(chunk)],
                    k, recalls, mrrs)
    return {"recall_at_10": float(np.mean(recalls)) if recalls else 0.0,
            "mrr": float(np.mean(mrrs)) if mrrs else 0.0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", type=str, default="")
    ap.add_argument("--synthetic", type=int, default=512)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--d_model", type=int, default=64)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--vocab_size", type=int, default=8192)
    ap.add_argument("--subword_ngrams", type=int, default=8)
    ap.add_argument("--doc_top_terms", type=int, default=128)
    ap.add_argument("--query_top_terms", type=int, default=32)
    ap.add_argument("--flops_lambda", type=float, default=3e-4)
    ap.add_argument("--out", type=str, default="data/splade.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variety", action="store_true")
    ap.add_argument("--eval_samples", type=int, default=0)
    ap.add_argument("--eval_every", type=int, default=0,
                    help="validation cadence for best-checkpoint "
                         "selection; 0 = steps//5 (module docstring)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the model trains and is evaluated "
                         "('cuda', 'cuda:i' or 'cpu')")
    args = ap.parse_args(argv)

    from .._host import require_device, to_device, upload_batch
    from ..core.dataset_loader import SyntheticHotpotQALoader
    from ..models.encoder import (EncoderConfig, TextEncoder,
                                  seeded_generator)
    from ..models.optim import clone_tree
    from ..models.splade import (
        SpladeConfig,
        SpladeEncoder,
        idf_lexical_prior,
        init_splade_params,
        make_splade_train_step,
    )
    from ..ops.splade import SpladeRetriever

    device = require_device(args.device)
    validation = []
    if args.input:
        samples = json.loads(Path(args.input).read_text(encoding="utf-8"))
        held_out = samples[len(samples) - args.eval_samples:] \
            if args.eval_samples else []
        samples = samples[: len(samples) - len(held_out)]
        if args.eval_samples and len(samples) > 2 * args.eval_samples:
            validation = samples[len(samples) - args.eval_samples:]
            samples = samples[: len(samples) - len(validation)]
    else:
        samples = SyntheticHotpotQALoader(
            {"count": args.synthetic, "seed": args.seed,
             "unique_entities": True, "variety": args.variety}).load()
        held_out = SyntheticHotpotQALoader(
            {"count": args.eval_samples, "seed": args.seed + 1,
             "index": args.synthetic, "unique_entities": True,
             "variety": args.variety}).load() if args.eval_samples else []
        validation = SyntheticHotpotQALoader(
            {"count": max(64, args.eval_samples // 2), "seed": args.seed + 2,
             "index": 2 * args.synthetic, "unique_entities": True,
             "variety": args.variety}).load() if args.eval_samples else []
    queries, passages = build_pairs(samples)
    print(f"training pairs: {len(queries)}")

    cfg = SpladeConfig(
        encoder=EncoderConfig(vocab_size=args.vocab_size,
                              d_model=args.d_model, n_layers=args.n_layers,
                              subword_ngrams=args.subword_ngrams),
        doc_top_terms=args.doc_top_terms,
        query_top_terms=args.query_top_terms,
        flops_lambda=args.flops_lambda)
    params = init_splade_params(seeded_generator(args.seed, device), cfg)
    # idf-initialize the lexical impact vector from the training passages
    # (models/splade.py docstring: a uniform prior ranks stop-word
    # matches as high as entity matches and held-out retrieval drowns)
    params["splade_head"]["lex_w"] = to_device(
        idf_lexical_prior(passages, cfg), device)
    init_state, step = make_splade_train_step(cfg, learning_rate=args.lr)
    opt_state = init_state(params)

    rng = np.random.default_rng(args.seed)
    n = len(queries)
    eval_every = args.eval_every or max(1, args.steps // 5)

    def val_score(p):
        v = eval_sparse(validation, SpladeRetriever(
            SpladeEncoder(cfg, params=p, device=device)))
        return (v["recall_at_10"], v["mrr"]), v

    # step 0 IS a candidate: on disjoint-entity validation the idf-prior
    # init is a strong lexical ranker, and training may never beat it.
    # The step updates the parameters in place, so a snapshot is a copy
    best_params, best_step, curve = clone_tree(params), 0, []
    best_key, v0 = (val_score(params) if validation
                    else ((-1.0, -1.0), None))
    if v0 is not None:
        curve.append({"step": 0, **v0})

    t0 = time.time()
    metrics = {}
    for i in range(args.steps):
        pick = rng.choice(n, size=min(args.batch, n), replace=False)
        batch = upload_batch(TextEncoder.make_pair_batch(
            [queries[j] for j in pick], [passages[j] for j in pick],
            cfg.encoder), device)
        params, opt_state, metrics = step(params, opt_state, batch)
        if (i + 1) % max(1, args.steps // 10) == 0:
            print(f"step {i + 1}/{args.steps} "
                  f"loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f} "
                  f"doc_nnz={float(metrics['doc_nnz']):.1f}")
        if validation and (i + 1) % eval_every == 0:
            key, v = val_score(params)
            curve.append({"step": i + 1, **v})
            print(f"  val@{i + 1}: recall {v['recall_at_10']:.3f} "
                  f"mrr {v['mrr']:.3f}")
            if key > best_key:
                best_key, best_params, best_step = (key, clone_tree(params),
                                                    i + 1)
    total = time.time() - t0
    if validation:
        params = best_params

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    enc = SpladeEncoder(cfg, params=params, device=device)
    enc.save(str(out))
    report = {"steps": args.steps, "pairs": n,
              "final_loss": float(metrics["loss"]) if metrics else None,
              "final_acc": float(metrics["accuracy"]) if metrics else None,
              "doc_nnz": float(metrics["doc_nnz"]) if metrics else None,
              "train_sec": round(total, 1), "out": str(out)}
    if validation:
        report["selected_step"] = best_step
        report["val_curve"] = [
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in row.items()} for row in curve]
    if held_out:
        report["held_out_splade"] = eval_sparse(
            held_out, SpladeRetriever(enc))
        report["held_out_bm25"] = eval_bm25(held_out, device=device)
        # deployment regime: the indexed corpus is the training corpus
        report["in_domain_splade"] = eval_sparse(
            samples, SpladeRetriever(enc))
        report["in_domain_bm25"] = eval_bm25(samples, device=device)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
