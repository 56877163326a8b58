#!/usr/bin/env python3
"""The sharded paths with one mesh position per card, against one card.

    python3 tools/sharded_multicard_check_torch.py      # every visible card

Runs `parallel.dryrun.dryrun_multichip` over the visible cards (one
position per card) and over twice as many positions (each card twice),
then the sharded hybrid engine (compact and dense graph forms, derived and
explicit seeds) and the sharded dense engine over the cards against the
single-device engine on the first card, on a 22,000-row collide corpus
with term_topm covering every posting list: ids must be identical and
scores within 1e-5. Prints ``MULTICARD OK`` at the end; any mismatch
raises. Needs at least two CUDA devices.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import numpy as np
    import torch

    from a_modular_rag_framework_torch.core.dataset_loader import (
        SyntheticHotpotQALoader)
    from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                      TorchQueryEngine)
    from a_modular_rag_framework_torch.eval.harness import evaluate_retrieval
    from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                     build_packed_index)
    from a_modular_rag_framework_torch.parallel import (ShardedDenseEngine,
                                                        ShardedHybridEngine,
                                                        build_mesh)
    from a_modular_rag_framework_torch.parallel.dryrun import dryrun_multichip

    n = torch.cuda.device_count()
    if n < 2:
        print(f"needs at least two CUDA devices, found {n}", file=sys.stderr)
        return 1
    cards = [torch.device("cuda", i) for i in range(n)]
    print(f"{n} cards: {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    dryrun_multichip(n, device="cuda")
    dryrun_multichip(2 * n, devices=cards * 2)
    print(f"dryrun over {n} cards and over {2 * n} positions on them: ok "
          f"({time.time() - t0:.1f}s)", flush=True)

    samples = SyntheticHotpotQALoader(
        {"count": 1000, "seed": 0, "n_distractors": 8,
         "collide_entities": True}).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=64, embed_dtype="bfloat16")
    base = dict(top_k=10, pool_k=200, graph_window=2, batch_buckets=(500,),
                query_df_ratio_max=0.05, bm25_term_topm=4096,
                graph_compact_cap=128, alpha_text=0.15, alpha_graph=0.70,
                alpha_dense=0.15, order_alphas=(0.4, 0.2, 0.4))
    mesh = build_mesh({"data": n}, devices=cards)
    qs = [s["question"] for s in samples]
    batches = [qs[:500], qs[500:]]
    for impl in ("compact", "dense"):
        cfg = EngineConfig(**base, graph_impl=impl)
        single = TorchQueryEngine(idx, device=cards[0], config=cfg)
        sharded = ShardedHybridEngine(idx, mesh=mesh, config=cfg)
        for b in batches:
            seeds = [[i, (7 * i + 1) % idx.n_docs] for i in range(len(b))]
            for kw in ({}, {"seed_rows": seeds}):
                r1 = single.query_batch(b, **kw)
                r2 = sharded.query_batch(b, **kw)
                if not np.array_equal(r1.hits.ids, r2.hits.ids):
                    raise RuntimeError(f"sharded hybrid ({impl}) ids differ")
                if np.abs(r1.hits.scores - r2.hits.scores).max() > 1e-5:
                    raise RuntimeError(f"sharded hybrid ({impl}) scores "
                                       f"differ")
        q = evaluate_retrieval(sharded, samples, k=10, batch_size=500)
        print(f"sharded hybrid ({impl}) over {n} cards == one card; recall@10 "
              f"{q['recall_at_10']:.4f}, MRR {q['mrr']:.4f}", flush=True)
    dense = ShardedDenseEngine(idx, mesh=mesh, batch_buckets=(500,))
    single = TorchQueryEngine(idx, device=cards[0],
                              config=EngineConfig(**base))
    for b in batches:
        got, want = dense.query_batch(b, top_k=10), single.query_dense_batch(
            b, top_k=10)
        if not (np.array_equal(got.ids, want.hits.ids)
                and np.array_equal(got.scores, want.hits.scores)):
            raise RuntimeError("sharded dense differs from one card")
    print(f"sharded dense over {n} cards == one card", flush=True)
    print("MULTICARD OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
