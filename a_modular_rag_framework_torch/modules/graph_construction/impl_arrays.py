"""Graph assembly + persistence: array-backed store with reference-format
JSON interop.

The port's copy of ``a_modular_rag_framework_tpu/modules/graph_construction/impl_arrays.py``.

Replaces the reference implementation's app/modules/graph_construction/impl_networkx.py
(nx.DiGraph + gexf/json/manifest) with an array store: nodes/edges are
kept as flat arrays (id table + COO edge arrays + packed CSR adjacency ready
for device frontier expansion) while persisting:

  graph.json     — {"graph_id", "node_count", "edge_count", "nodes", "edges"}
                   (the exact shape graph_utils.load_graph_json consumes)
  manifest.json  — ids, counts, paths
  adjacency.npz  — CSR of sentence-graph next_in_doc edges + q_match seed
                   rows, loadable straight into `ops.graph.expand_frontier`
  analysis/      — offline stats (utils.graph_analyzer)

Complex attribute values are JSON-encoded strings in graph.json, matching
the reference's sanitization so third-party readers agree.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from ...core.dto import GraphBuildIn, GraphBuildOut
from ...utils.graph_analyzer import analyze_graph_file


def _sanitize(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, dict)):
            out[k] = json.dumps(v, ensure_ascii=False, default=str)
        else:
            out[k] = str(v)
    return out


def pack_adjacency(nodes: List[Dict[str, Any]], edges: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Node-id table + undirected next_in_doc neighbor lists + q_match seeds,
    as arrays for the device query path."""
    node_ids = [n["id"] for n in nodes]
    row_of = {nid: i for i, nid in enumerate(node_ids)}
    n = len(node_ids)

    adj: List[List[int]] = [[] for _ in range(n)]
    seeds: List[int] = []
    for e in edges:
        s, t = row_of.get(e.get("source")), row_of.get(e.get("target"))
        if s is None or t is None:
            continue
        etype = e.get("type")
        if etype == "next_in_doc":
            adj[s].append(t)
            adj[t].append(s)
        elif etype == "q_match" and e.get("source") == "q1":
            seeds.append(t)

    max_deg = max((len(a) for a in adj), default=1) or 1
    nbrs = np.full((n, max_deg), -1, dtype=np.int32)
    for i, a in enumerate(adj):
        nbrs[i, : len(a)] = a[:max_deg]
    return {
        "neighbors": nbrs,
        "qmatch_seeds": np.asarray(sorted(set(seeds)), dtype=np.int32),
    }


class GraphConstructionArrays:
    """Assemble, persist, and summarize one per-question evidence graph."""

    def __init__(self, root_dir: str = "data/graph", write_analysis: bool = True):
        self.root_dir = Path(root_dir)
        self.root_dir.mkdir(parents=True, exist_ok=True)
        self.write_analysis = write_analysis

    def build(self, req: GraphBuildIn) -> GraphBuildOut:
        graph_id = req.graph_id or "graph-unknown"
        # de-dup nodes by id (first wins), drop dangling edges
        seen = set()
        nodes: List[Dict[str, Any]] = []
        for nd in req.nodes:
            nid = nd.get("id")
            if nid is None or nid in seen:
                continue
            seen.add(nid)
            nodes.append(dict(nd))
        edges = [dict(e) for e in req.edges
                 if e.get("source") in seen and e.get("target") in seen]

        out_dir = self.root_dir / graph_id
        out_dir.mkdir(parents=True, exist_ok=True)

        json_nodes = [{"id": nd["id"], **_sanitize({k: v for k, v in nd.items()})}
                      for nd in nodes]
        json_edges = [{"source": e["source"], "target": e["target"],
                       **_sanitize({k: v for k, v in e.items()
                                    if k not in ("source", "target")})}
                      for e in edges]
        summary = {
            "graph_id": graph_id,
            "node_count": len(nodes),
            "edge_count": len(edges),
            "nodes": json_nodes,
            "edges": json_edges,
        }
        json_path = out_dir / "graph.json"
        json_path.write_text(json.dumps(summary, ensure_ascii=False, indent=2),
                             encoding="utf-8")

        gexf_path = out_dir / "graph.gexf"
        try:  # optional GEXF for interop with reference-era tooling
            import networkx as nx

            G = nx.DiGraph()
            for nd in json_nodes:
                G.add_node(nd["id"], **{k: v for k, v in nd.items()
                                        if k != "id" and v is not None})
            for e in json_edges:
                G.add_edge(e["source"], e["target"],
                           **{k: v for k, v in e.items()
                              if k not in ("source", "target") and v is not None})
            nx.write_gexf(G, gexf_path)
        except Exception:
            gexf_path = None

        packed = pack_adjacency(nodes, edges)
        np.savez(out_dir / "adjacency.npz",
                 neighbors=packed["neighbors"],
                 qmatch_seeds=packed["qmatch_seeds"],
                 # fixed-width unicode, NOT dtype=object: keeps the artifact
                 # loadable with allow_pickle=False (pickle loading of an
                 # attacker-supplied graph dir would be arbitrary code exec)
                 node_ids=np.asarray([str(nd["id"]) for nd in nodes], dtype=str))

        manifest = {
            "graph_id": graph_id,
            "node_count": len(nodes),
            "edge_count": len(edges),
            "paths": {
                "dir": str(out_dir),
                "json": str(json_path),
                "gexf": str(gexf_path) if gexf_path else None,
                "adjacency": str(out_dir / "adjacency.npz"),
                "manifest": str(out_dir / "manifest.json"),
            },
        }
        (out_dir / "manifest.json").write_text(
            json.dumps(manifest, ensure_ascii=False, indent=2), encoding="utf-8"
        )

        analysis: Dict[str, Any]
        if self.write_analysis:
            try:
                analysis = analyze_graph_file(json_path, out_dir / "analysis")
            except Exception as e:  # analysis is best-effort
                analysis = {"error": f"{e.__class__.__name__}: {e}"}
        else:
            analysis = {"skipped": True}

        diag: Dict[str, Any] = {
            "node_types": dict(Counter(nd.get("type") for nd in nodes)),
            "edge_types": dict(Counter(e.get("type") for e in edges)),
            "analysis": analysis,
        }
        if isinstance(req.extra, dict):
            for key in ("node_builder_diagnostics", "edge_builder_diagnostics", "diagnostics"):
                v = req.extra.get(key)
                if isinstance(v, dict) and v:
                    diag[key] = v
            ev_counts: Counter = Counter()
            for e in edges:
                for ev in e.get("evidence") or []:
                    ch = ev.get("channel") if isinstance(ev, dict) else None
                    if ch:
                        ev_counts[ch] += 1
            if ev_counts:
                diag["evidence_channels"] = dict(ev_counts)

        provenance: Dict[str, Any] = {"impl": "arrays", "graph_id": graph_id}
        if isinstance(req.extra, dict) and "policy" in req.extra:
            provenance["policy"] = req.extra["policy"]

        return GraphBuildOut(
            graph_id=graph_id,
            node_count=len(nodes),
            edge_count=len(edges),
            nodes=nodes,
            edges=edges,
            provenance=provenance,
            diagnostics=diag,
            extra={"paths": manifest["paths"]},
        )
