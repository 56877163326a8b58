#!/usr/bin/env python3
"""Sharded vs single-device hybrid quality at two phase-1 window widths, on
the CPU, in either package.

    python tools/sharded_window_gap.py --package torch --samples 4600
    python tools/sharded_window_gap.py --package jax --samples 4600

Builds the collide corpus (seed 0, 8 distractors; 4,600 samples -> 101,200
rows), runs `evaluate_retrieval` over every question with the single-device
engine and with the sharded hybrid engine over ``--shards`` shards, at the
scale operating point (bm25_term_topm 16, compact graph) and with a window
covering every posting list (bm25_term_topm 4096), and prints one JSON
line of recall@10 and MRR per engine and width. Each shard's phase-1 window
takes bm25_term_topm postings of its own list, a superset of the
single-device window, so the two engines agree exactly only where the
window covers the lists. The torch side runs ``["cpu"] * shards``; the jax
side needs ``XLA_FLAGS=--xla_force_host_platform_device_count=<shards>``
(set here before jax loads).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
# chip_smoke.SCALE_CONFIG, with the batch bucket set by --batch
SCALE = dict(top_k=10, pool_k=200, graph_window=2, query_df_ratio_max=0.05,
             graph_compact_cap=128, dense_impl="pool", alpha_text=0.15,
             alpha_graph=0.70, alpha_dense=0.15, order_alphas=(0.4, 0.2, 0.4),
             graph_impl="compact")


def engines(package: str, samples_n: int, shards: int):
    """(samples, make_single(cfg), make_sharded(cfg), EngineConfig, evaluate)."""
    loader_cfg = {"count": samples_n, "seed": 0, "n_distractors": 8,
                  "collide_entities": True}
    if package == "torch":
        from a_modular_rag_framework_torch.core.dataset_loader import (
            SyntheticHotpotQALoader)
        from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                          TorchQueryEngine)
        from a_modular_rag_framework_torch.eval.harness import (
            evaluate_retrieval)
        from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                         build_packed_index)
        from a_modular_rag_framework_torch.parallel import (
            ShardedHybridEngine, build_mesh)

        samples = SyntheticHotpotQALoader(loader_cfg).load()
        idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                                 embed_dim=64, embed_dtype="bfloat16")
        mesh = build_mesh({"data": shards}, devices=["cpu"] * shards)
        return (samples,
                lambda c: TorchQueryEngine(idx, device="cpu", config=c),
                lambda c: ShardedHybridEngine(idx, mesh=mesh, config=c),
                EngineConfig, evaluate_retrieval)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={shards}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader)
    from a_modular_rag_framework_tpu.engine.query_engine import (
        EngineConfig, TPUQueryEngine)
    from a_modular_rag_framework_tpu.eval.harness import evaluate_retrieval
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
    from a_modular_rag_framework_tpu.parallel.mesh import build_mesh
    from a_modular_rag_framework_tpu.parallel.sharded_hybrid import (
        ShardedHybridEngine)

    samples = SyntheticHotpotQALoader(loader_cfg).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=64, embed_dtype="bfloat16")
    mesh = build_mesh({"data": shards})
    # the JAX engine's exact graph pool and f32 waves: the port's semantics
    return (samples, lambda c: TPUQueryEngine(idx, config=c),
            lambda c: ShardedHybridEngine(idx, mesh=mesh, config=c),
            lambda **kw: EngineConfig(graph_pool_exact=True,
                                      graph_wave_dtype="float32", **kw),
            evaluate_retrieval)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--samples", type=int, default=4600)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--batch", type=int, default=1150)
    args = ap.parse_args()
    samples, single, sharded, config, evaluate = engines(
        args.package, args.samples, args.shards)
    out = {"package": args.package, "samples": args.samples,
           "shards": args.shards}
    for topm in (16, 4096):
        cfg = config(**SCALE, batch_buckets=(args.batch,), bm25_term_topm=topm)
        for name, make in (("single", single), ("sharded", sharded)):
            r = evaluate(make(cfg), samples, k=10, batch_size=args.batch)
            out[f"{name}_topm{topm}"] = {"recall_at_10": r["recall_at_10"],
                                         "mrr": r["mrr"]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
