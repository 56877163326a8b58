"""Offline graph analysis tooling.

The port's copy of ``a_modular_rag_framework_tpu/utils/graph_analyzer.py``.

Capability parity with the reference implementation's app/utils/graph_analyzer.py:9-71:
edge-type distribution, top-degree nodes, weak-connectivity components,
degree centrality, optional histogram PNGs. Connectivity/centrality are
computed with flat arrays + union-find (no networkx requirement); the
matplotlib plots degrade gracefully when unavailable.
"""
from __future__ import annotations

import json
from collections import Counter, defaultdict
from pathlib import Path
from typing import Any, Dict, List


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1


def analyze_graph_file(json_path, output_dir) -> Dict[str, Any]:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    data = json.loads(Path(json_path).read_text(encoding="utf-8"))
    nodes: List[Dict[str, Any]] = data.get("nodes", [])
    edges: List[Dict[str, Any]] = data.get("edges", [])

    # edge-type distribution
    edge_type_counts = dict(Counter(e.get("type") for e in edges))
    (output_dir / "edge_type_stats.json").write_text(
        json.dumps(edge_type_counts, indent=2, default=str), encoding="utf-8"
    )

    # degree + top nodes
    degree: Dict[str, int] = defaultdict(int)
    for e in edges:
        degree[e.get("source")] += 1
        degree[e.get("target")] += 1
    top_nodes = sorted(degree.items(), key=lambda kv: kv[1], reverse=True)[:10]
    (output_dir / "top_nodes.json").write_text(
        json.dumps(top_nodes, indent=2, default=str), encoding="utf-8"
    )

    # weak connectivity via union-find
    idx = {n.get("id"): i for i, n in enumerate(nodes)}
    uf = _UnionFind(len(nodes))
    for e in edges:
        s, t = idx.get(e.get("source")), idx.get(e.get("target"))
        if s is not None and t is not None:
            uf.union(s, t)
    comp_sizes_map: Dict[int, int] = defaultdict(int)
    for i in range(len(nodes)):
        comp_sizes_map[uf.find(i)] += 1
    comp_sizes = sorted(comp_sizes_map.values(), reverse=True)
    connectivity = {
        "is_weakly_connected": len(comp_sizes) <= 1,
        "num_components": len(comp_sizes),
        "component_sizes": comp_sizes[:5],
    }
    (output_dir / "connectivity.json").write_text(
        json.dumps(connectivity, indent=2), encoding="utf-8"
    )

    # degree centrality: deg / (n - 1)
    denom = max(len(nodes) - 1, 1)
    centrality = {nid: d / denom for nid, d in degree.items()}
    top_cent = sorted(centrality.items(), key=lambda kv: kv[1], reverse=True)[:10]
    (output_dir / "top_centrality.json").write_text(
        json.dumps(top_cent, indent=2, default=str), encoding="utf-8"
    )

    plots = False
    try:  # plots are best-effort
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if edge_type_counts:
            plt.figure(figsize=(8, 4))
            plt.bar(list(map(str, edge_type_counts.keys())),
                    list(edge_type_counts.values()), color="skyblue")
            plt.title("Edge Type Distribution")
            plt.xticks(rotation=30)
            plt.tight_layout()
            plt.savefig(output_dir / "edge_distribution.png")
            plt.close()
        if len(comp_sizes) > 1:
            plt.figure(figsize=(6, 4))
            plt.bar(range(1, len(comp_sizes[:10]) + 1), comp_sizes[:10],
                    color="lightcoral")
            plt.title("Top Component Sizes")
            plt.tight_layout()
            plt.savefig(output_dir / "component_sizes.png")
            plt.close()
        plots = True
    except Exception:
        pass

    return {
        "edge_type_counts": edge_type_counts,
        "top_nodes": top_nodes,
        "connectivity": connectivity,
        "top_centrality": top_cent,
        "plots_written": plots,
    }
