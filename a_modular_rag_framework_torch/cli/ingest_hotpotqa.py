"""Ingest CLI: HotpotQA -> docs.jsonl + packed index (+ per-sample graphs).

The port's copy of ``a_modular_rag_framework_tpu/cli/ingest_hotpotqa.py``.

Role parity with the reference implementation's my_code/ingest_hotpotqa.py: flattens context
sentences into the docs.jsonl corpus and builds per-sample supporting-fact
graphs (page nodes + bidirectional ``supporting`` edges). Addition: the
same pass runs the streaming embed+pack pipeline so the corpus comes out as
a device-ready `PackedIndex` (embeddings, BM25 CSR, sentence adjacency).

Usage:
  python -m a_modular_rag_framework_torch.cli.ingest_hotpotqa \
      --input data/hotpotqa/hotpot_dev_distractor_v1.json \
      --docs_out data/hotpotqa/docs.jsonl --graph_root data/graph/hotpotqa \
      --limit 500
  # or, without a dataset file:
  python -m a_modular_rag_framework_torch.cli.ingest_hotpotqa \
      --synthetic 200 --docs_out data/hotpotqa/docs.jsonl
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List

from ..core.dataset_loader import SyntheticHotpotQALoader
from ..core.dto import GraphBuildIn
from ..index.builder import build_packed_index
from ..index.corpus import SentenceCorpus, write_docs_jsonl, flatten_hotpotqa_context
from ..modules.graph_construction.impl_arrays import GraphConstructionArrays


def supporting_fact_graph(sample: Dict[str, Any]) -> Dict[str, Any]:
    """Page nodes + bidirectional supporting edges between supporting-fact
    titles (the raw v1 request shape of the reference ingest)."""
    sid = sample.get("_id") or sample.get("id")
    nodes = [{"id": title, "type": "page", "props": {"title": title}}
             for title, _ in sample.get("context", [])]
    sf_titles = sorted({t for t, _ in sample.get("supporting_facts", [])})
    edges: List[Dict[str, Any]] = []
    for i, a in enumerate(sf_titles):
        for b in sf_titles[i + 1:]:
            edges.append({"source": a, "target": b, "type": "supporting", "props": {}})
            edges.append({"source": b, "target": a, "type": "supporting", "props": {}})
    return {"graph_id": f"hotpotqa-{sid}", "nodes": nodes, "edges": edges}


def ingest(
    samples: List[Dict[str, Any]],
    *,
    graph_root: Path,
    docs_out: Path,
    embed_dim: int = 64,
    embed_dtype: str = "bfloat16",
    build_graphs: bool = True,
    pack: bool = True,
    index_titles: bool = False,
) -> Dict[str, Any]:
    gc = GraphConstructionArrays(root_dir=str(graph_root), write_analysis=False)
    if build_graphs:
        for i, sample in enumerate(samples):
            raw = supporting_fact_graph(sample)
            gc.build(GraphBuildIn(
                graph_id=raw["graph_id"], nodes=raw["nodes"],
                edges=raw["edges"], trace_id=f"trace-hotpot-{i}",
            ))

    docs = list(flatten_hotpotqa_context(samples))
    write_docs_jsonl(docs, docs_out)

    stats: Dict[str, Any] = {"samples": len(samples), "sentences": len(docs)}
    if pack:
        corpus = SentenceCorpus(docs=docs)
        packed_dir = docs_out.with_suffix(docs_out.suffix + ".packed")
        idx = build_packed_index(corpus, embed_dim=embed_dim,
                                 embed_dtype=embed_dtype,
                                 index_titles=index_titles,
                                 out_dir=str(packed_dir))
        stats["packed"] = idx.manifest.get("build_stats", {})
        stats["packed_dir"] = str(packed_dir)
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Ingest HotpotQA into docs + packed TPU index")
    ap.add_argument("--input", type=str,
                    default="data/hotpotqa/hotpot_dev_distractor_v1.json")
    ap.add_argument("--graph_root", type=str, default="data/graph/hotpotqa")
    ap.add_argument("--docs_out", type=str, default="data/hotpotqa/docs.jsonl")
    ap.add_argument("--limit", type=int, default=500, help="0 = all")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic samples instead of reading --input")
    ap.add_argument("--embed_dim", type=int, default=64)
    ap.add_argument("--embed_dtype", type=str, default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--no_graphs", action="store_true")
    ap.add_argument("--no_pack", action="store_true")
    ap.add_argument("--index_titles", action="store_true",
                    help="prepend doc titles to the indexed text (natural "
                         "discourse corpora; see index/builder.py)")
    args = ap.parse_args(argv)

    if args.synthetic:
        samples = SyntheticHotpotQALoader({"count": args.synthetic}).load()
    else:
        path = Path(args.input)
        if not path.exists():
            raise FileNotFoundError(f"HotpotQA file not found: {path}")
        with open(path, "r", encoding="utf-8") as f:
            samples = json.load(f)
        if args.limit:
            samples = samples[: args.limit]

    stats = ingest(
        samples,
        graph_root=Path(args.graph_root),
        docs_out=Path(args.docs_out),
        embed_dim=args.embed_dim,
        embed_dtype=args.embed_dtype,
        build_graphs=not args.no_graphs,
        pack=not args.no_pack,
        index_titles=args.index_titles,
    )
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
