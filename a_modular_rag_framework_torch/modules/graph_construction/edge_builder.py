"""Edge construction with multi-channel vote fusion (G2+G3+G4).

The port's copy of ``a_modular_rag_framework_tpu/modules/graph_construction/edge_builder.py``.

Capability parity with the reference implementation's app/modules/graph_construction/
edge_builder.py:10-222 — five edge channels (next_in_doc / in_doc / q_match /
semantic_sim / mentions), weighted channel-vote fusion over `EdgeEvidence`,
sparsification by ``edge_min_vote`` / ``max_edges_per_node``, diagnostics.

Difference from the reference: the G2 semantic channel embeds ALL sentences as one
device batch and computes every pairwise cosine with a single matmul +
threshold + optional per-node top-k (`ops.semantic`) — replacing the
reference's O(n^2) python pair loop with its per-text embed calls.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ...core.dto import EdgeEvidence, GraphEdge, GraphNode
from ...models.hash_embed import hash_embed_numpy
from ...ops.semantic import semantic_edges

_WORD = re.compile(r"\w+")

DEFAULT_ASSEMBLY_POLICY: Dict[str, Any] = {
    "channels": {"q_overlap": 1.0, "embed_sim": 1.0, "entity_link": 0.6,
                 "position_prior": 0.2},
    "edge_min_vote": 0.6,
    "max_edges_per_node": 64,
}


class EdgeBuilder:
    def __init__(
        self,
        use_adjacency: bool = True,
        use_qmatch: bool = True,
        use_doc_edges: bool = True,
        use_entity_edges: bool = True,
        use_semantic_edges: bool = True,
        semantic_threshold: float = 0.9,
        semantic_top_k_per_node: int = 0,
        embedder: Optional[Callable[[List[str]], np.ndarray]] = None,
        record_evidence: bool = True,
        assembly_policy: Optional[Dict[str, Any]] = None,
        device="cuda",
    ):
        self.use_adjacency = use_adjacency
        self.use_qmatch = use_qmatch
        self.use_doc_edges = use_doc_edges
        self.use_entity_edges = use_entity_edges
        self.use_semantic_edges = use_semantic_edges
        self.semantic_threshold = float(semantic_threshold)
        self.semantic_top_k_per_node = int(semantic_top_k_per_node)
        self.embedder = embedder  # batched: List[str] -> [n, d]
        self.record_evidence = record_evidence
        self.assembly_policy = dict(assembly_policy or DEFAULT_ASSEMBLY_POLICY)
        self.last_diagnostics: Dict[str, Any] = {}
        self.device = device  # where the semantic-edge program runs

    # ---- scoring helpers ----

    @staticmethod
    def _position_prior(a_meta: Dict[str, Any], b_meta: Dict[str, Any]) -> float:
        """Weak prior for physically adjacent sentences of the same doc."""
        try:
            if (a_meta.get("doc") and a_meta.get("doc") == b_meta.get("doc")
                    and abs(int(a_meta.get("sent_id", -1)) - int(b_meta.get("sent_id", -1))) == 1):
                return 0.8
        except (TypeError, ValueError):
            pass
        return 0.0

    def _vote(self, evidences: Sequence[EdgeEvidence]) -> float:
        weights = self.assembly_policy.get("channels", {}) or {}
        total = sum(float(weights.get(ev.channel, 0.0)) * float(ev.score)
                    for ev in evidences)
        return max(0.0, min(1.0, total))

    def _emit(
        self,
        bag: List[GraphEdge],
        src: str,
        tgt: str,
        etype: str,
        *,
        base_weight: float,
        evidence: Optional[List[EdgeEvidence]] = None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> None:
        ev = list(evidence or [])
        weight = self._vote(ev) if ev else float(base_weight)
        edge = GraphEdge(source=src, target=tgt, type=etype,
                         weight=round(weight, 3), meta=meta or {})
        if self.record_evidence and ev:
            edge.evidence = ev
        bag.append(edge)

    # ---- main ----

    def build(
        self,
        nodes: Sequence[Any],
        question: str,
        policy: Optional[Dict[str, Any]] = None,
    ) -> List[Dict[str, Any]]:
        policy = policy or {}
        gnodes = [n if isinstance(n, GraphNode) else GraphNode(**n) for n in nodes]
        disabled = set(policy.get("disable_edges", []) or [])

        q_node = next((n for n in gnodes if n.type == "question"), None)
        sent_nodes = [n for n in gnodes if n.type == "sentence"]
        doc_nodes = {n.id for n in gnodes if n.type == "document"}
        ent_nodes = [n for n in gnodes if n.type == "entity"]

        edges: List[GraphEdge] = []

        # 1) next_in_doc: consecutive sentences per document
        if self.use_adjacency and "next_in_doc" not in disabled:
            per_doc: Dict[str, List[GraphNode]] = defaultdict(list)
            for s in sent_nodes:
                per_doc[str(s.meta.get("doc", "default"))].append(s)
            for doc, sents in per_doc.items():
                ordered = sorted(sents, key=lambda x: int(x.meta.get("sent_id", 0)))
                for a, b in zip(ordered, ordered[1:]):
                    ev = []
                    prior = self._position_prior(a.meta, b.meta)
                    if prior > 0:
                        ev.append(EdgeEvidence(channel="position_prior",
                                               score=prior, meta={"reason": "adjacent"}))
                    self._emit(edges, a.id, b.id, "next_in_doc",
                               base_weight=1.0, evidence=ev, meta={"doc": doc})

        # 2) in_doc: sentence -> its document node
        if self.use_doc_edges and "in_doc" not in disabled:
            for s in sent_nodes:
                doc_id = f"doc::{s.meta.get('doc')}"
                if doc_id in doc_nodes:
                    ev = [EdgeEvidence(channel="position_prior", score=0.4,
                                       meta={"reason": "in_doc"})]
                    self._emit(edges, s.id, doc_id, "in_doc", base_weight=1.0,
                               evidence=ev, meta={"doc": s.meta.get("doc")})

        # 3) q_match: question-token overlap fraction
        if self.use_qmatch and q_node is not None and "q_match" not in disabled:
            q_words = set(w.lower() for w in _WORD.findall(q_node.text or ""))
            for s in sent_nodes:
                s_words = set(w.lower() for w in _WORD.findall(s.text or ""))
                overlap = q_words & s_words
                if overlap:
                    frac = min(1.0, len(overlap) / (len(q_words) + 1e-6))
                    ev = [EdgeEvidence(channel="q_overlap", score=float(frac),
                                       meta={"overlap": sorted(overlap)})]
                    self._emit(edges, q_node.id, s.id, "q_match",
                               base_weight=frac, evidence=ev,
                               meta={"overlap": sorted(overlap)})

        # 4) semantic_sim: one batched matmul over all sentence embeddings
        if self.use_semantic_edges and "semantic_sim" not in disabled and len(sent_nodes) > 1:
            texts = [s.text or "" for s in sent_nodes]
            embedder = policy.get("embed_fn") or self.embedder or (
                lambda ts: hash_embed_numpy(ts, dim=64)
            )
            emb = np.asarray(embedder(texts), dtype=np.float32)
            for i, j, sim in semantic_edges(
                emb, threshold=self.semantic_threshold,
                top_k_per_node=self.semantic_top_k_per_node,
                device=self.device,
            ):
                a, b = sent_nodes[i], sent_nodes[j]
                ev = [EdgeEvidence(channel="embed_sim", score=float(sim), meta={})]
                prior = self._position_prior(a.meta, b.meta)
                if prior > 0:
                    ev.append(EdgeEvidence(channel="position_prior", score=prior, meta={}))
                self._emit(edges, a.id, b.id, "semantic_sim", base_weight=sim,
                           evidence=ev, meta={"similarity": round(float(sim), 3)})

        # 5) mentions: sentence -> entity (substring containment)
        if self.use_entity_edges and "mentions" not in disabled:
            for s in sent_nodes:
                if not s.text:
                    continue
                for e in ent_nodes:
                    if e.text and e.text in s.text:
                        ev = [EdgeEvidence(channel="entity_link", score=0.6,
                                           meta={"reason": "substring"})]
                        self._emit(edges, s.id, e.id, "mentions", base_weight=1.0,
                                   evidence=ev, meta={"entity": e.text})

        # ---- sparsification (G4) ----
        n_before = len(edges)
        min_vote = float(self.assembly_policy.get("edge_min_vote", 0.0) or 0.0)
        max_per_node = int(self.assembly_policy.get("max_edges_per_node", 0) or 0)
        edges = [e for e in edges if e.weight >= min_vote]
        if max_per_node > 0:
            per_node: Dict[str, List[GraphEdge]] = defaultdict(list)
            for e in edges:
                per_node[e.source].append(e)
                per_node[e.target].append(e)
            kept: Dict[tuple, GraphEdge] = {}
            for lst in per_node.values():
                for e in sorted(lst, key=lambda x: x.weight, reverse=True)[:max_per_node]:
                    key = (e.source, e.target, e.type)
                    if key not in kept or e.weight > kept[key].weight:
                        kept[key] = e
            edges = list(kept.values())
        n_after = len(edges)

        type_counts: Dict[str, int] = defaultdict(int)
        for e in edges:
            type_counts[e.type] += 1
        self.last_diagnostics = {
            "config": {
                "use_adjacency": self.use_adjacency,
                "use_qmatch": self.use_qmatch,
                "use_doc_edges": self.use_doc_edges,
                "use_entity_edges": self.use_entity_edges,
                "use_semantic_edges": self.use_semantic_edges,
                "semantic_threshold": self.semantic_threshold,
                "fusion_enabled": True,
                "assembly_policy": self.assembly_policy,
            },
            "edge_counts": dict(type_counts),
            "total_edges": n_after,
            "total_edges_before_prune": n_before,
            "total_edges_after_prune": n_after,
        }
        return [e.model_dump() for e in edges]
