"""Train the TextEncoder contrastively and export weights (port of
``a_modular_rag_framework_tpu/cli/train_encoder.py``).

Trains on (question, supporting-sentence) pairs from a HotpotQA-style
dataset (real file or synthetic), with in-batch InfoNCE. The exported
weights load back through ``TextEncoder`` of either package and plug into
the engine as the dense-channel encoder.

Usage:
  python -m a_modular_rag_framework_torch.cli.train_encoder \
      --synthetic 512 --steps 200 --out data/encoder.npz

The arguments, defaults, printed lines and report keys are the original's;
``--device`` (default ``cuda``) is added. Batches are drawn with
``np.random.default_rng(seed)`` as there; the fresh parameters come from a
seeded ``torch.Generator``, not from JAX's PRNG, so a run here does not
reproduce a run there step by step.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def build_pairs(samples) -> Tuple[List[str], List[str]]:
    """(question, supporting-fact sentence) pairs — one pair per
    supporting fact, so the encoder sees both the bridge sentence and the
    answer-bearing sentence of each multi-hop chain."""
    queries, passages = [], []
    for s in samples:
        ctx = {t: sents for t, sents in s.get("context", [])}
        for title, sid in s.get("supporting_facts", []):
            sents = ctx.get(title) or []
            if 0 <= sid < len(sents):
                queries.append(s["question"])
                passages.append(sents[sid])
    return queries, passages


def evaluate_encoder(samples, encoder, embed_dim: int,
                     device="cuda") -> Dict[str, float]:
    """Held-out retrieval quality: build a fresh index over ``samples``
    with the given encoder (None = hash baseline) and run the full hybrid
    engine over their questions."""
    from ..engine.query_engine import EngineConfig, TorchQueryEngine
    from ..eval.harness import evaluate_retrieval
    from ..index.builder import build_packed_index
    from ..index.corpus import SentenceCorpus

    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus, encoder=encoder,
                             embed_dim=embed_dim, embed_dtype="float32")
    engine = TorchQueryEngine(
        idx, device=device, encoder=encoder,
        config=EngineConfig(top_k=10, pool_k=200, graph_window=2,
                            batch_buckets=(64,)),
    )
    q = evaluate_retrieval(engine, samples, k=10, batch_size=64)
    return {"recall_at_10": q["recall_at_10"], "mrr": q["mrr"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", type=str, default="")
    ap.add_argument("--synthetic", type=int, default=512)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--d_model", type=int, default=64)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--out", type=str, default="data/encoder.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variety", action="store_true",
                    help="train on the harder variety-template corpus")
    ap.add_argument("--subword_ngrams", type=int, default=1,
                    help="features per word (1 = whole-word hash only; "
                         ">1 adds char n-grams so unseen names share "
                         "trained buckets)")
    ap.add_argument("--eval_samples", type=int, default=0,
                    help="held-out samples for a hash-vs-trained recall "
                         "comparison after training")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the model trains and is evaluated "
                         "('cuda', 'cuda:i' or 'cpu')")
    args = ap.parse_args(argv)

    from .._host import require_device, upload_batch
    from ..core.dataset_loader import SyntheticHotpotQALoader
    from ..models.encoder import (
        EncoderConfig,
        TextEncoder,
        init_params,
        make_train_step,
        seeded_generator,
    )

    device = require_device(args.device)
    if args.input:
        samples = json.loads(Path(args.input).read_text(encoding="utf-8"))
        held_out = samples[len(samples) - args.eval_samples:] \
            if args.eval_samples else []
        samples = samples[: len(samples) - len(held_out)]
    else:
        samples = SyntheticHotpotQALoader(
            {"count": args.synthetic, "seed": args.seed,
             "unique_entities": True, "variety": args.variety}
        ).load()
        held_out = SyntheticHotpotQALoader(
            {"count": args.eval_samples, "seed": args.seed + 1,
             "index": args.synthetic, "unique_entities": True,
             "variety": args.variety}
        ).load() if args.eval_samples else []
    queries, passages = build_pairs(samples)
    print(f"training pairs: {len(queries)}")

    cfg = EncoderConfig(d_model=args.d_model, n_layers=args.n_layers,
                    subword_ngrams=args.subword_ngrams)
    params = init_params(seeded_generator(args.seed, device), cfg)
    init_state, step = make_train_step(cfg, learning_rate=args.lr)
    opt_state = init_state(params)

    rng = np.random.default_rng(args.seed)
    n = len(queries)
    t0 = time.time()
    for i in range(args.steps):
        idx = rng.choice(n, size=min(args.batch, n), replace=False)
        batch = upload_batch(TextEncoder.make_pair_batch(
            [queries[j] for j in idx], [passages[j] for j in idx], cfg),
            device)
        params, opt_state, metrics = step(params, opt_state, batch)
        if (i + 1) % max(1, args.steps // 10) == 0:
            print(f"step {i + 1}/{args.steps} "
                  f"loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f}")
    total = time.time() - t0

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    trained = TextEncoder(cfg, params=params, device=device)
    trained.save(str(out))
    report = {"steps": args.steps, "pairs": n,
              "final_loss": float(metrics["loss"]),
              "final_acc": float(metrics["accuracy"]),
              "train_sec": round(total, 1),
              "out": str(out)}
    if held_out:
        report["held_out"] = {
            "n": len(held_out),
            "hash": evaluate_encoder(held_out, None, cfg.d_model,
                                     device=device),
            "trained": evaluate_encoder(held_out, trained, cfg.d_model,
                                        device=device),
        }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
