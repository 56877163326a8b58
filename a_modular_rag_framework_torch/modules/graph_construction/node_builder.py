"""Node construction for per-question evidence graphs.

The port's copy of ``a_modular_rag_framework_tpu/modules/graph_construction/node_builder.py``.

Capability parity with the reference implementation's app/modules/graph_construction/
node_builder.py:12-104: question / sentence / document / entity nodes, with
optional G1 segmentation and G3 entity nodes (regex caps-spans union entity
linker output). Node id scheme matches the reference so persisted graphs
interoperate: ``q1``, ``{doc}::sent{j}`` (or ``sent{i}`` for untitled
context), ``doc::{title}``, ``ent::{Entity_Name}``.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ...core.dto import GraphNode
from ...utils.entity_linker import elq_link_entities
from .segmenter import segment_context

from ...utils.textspan import capitalized_runs

ContextItem = Union[str, Tuple[Any, Any], List[Any], Dict[str, Any]]


def normalize_context(context: Sequence[ContextItem]) -> List[Tuple[str, List[str]]]:
    """Accept str | (title, sents) | {"title", "sentences"} items."""
    out: List[Tuple[str, List[str]]] = []
    for item in context or []:
        if isinstance(item, str):
            out.append(("default", [item]))
        elif isinstance(item, (tuple, list)) and len(item) == 2:
            out.append((str(item[0]), [str(x) for x in item[1]]))
        elif isinstance(item, dict) and "title" in item and "sentences" in item:
            out.append((str(item["title"]), [str(x) for x in item["sentences"]]))
    return out


class NodeBuilder:
    """Builds the node set; emits diagnostics about segmentation + counts."""

    def __init__(
        self,
        enable_segmentation: bool = True,
        segmentation_strategy: str = "rule",
        segmentation_sim_threshold: float = 0.65,
        use_entity_nodes: bool = True,
        use_doc_nodes: bool = True,
        embedder: Optional[Callable[[List[str]], np.ndarray]] = None,
    ):
        self.enable_segmentation = enable_segmentation
        self.segmentation_strategy = segmentation_strategy
        self.segmentation_sim_threshold = segmentation_sim_threshold
        self.use_entity_nodes = use_entity_nodes
        self.use_doc_nodes = use_doc_nodes
        self.embedder = embedder
        self.last_diagnostics: Dict[str, Any] = {}

    def build(
        self,
        question: str,
        context: Sequence[ContextItem],
        policy: Optional[Dict[str, Any]] = None,
    ) -> List[GraphNode]:
        policy = policy or {}
        nodes: List[GraphNode] = []

        if question:
            nodes.append(GraphNode(id="q1", type="question", text=question,
                                   meta={"source": "question"}))

        ctx_before = normalize_context(context)
        ctx = ctx_before
        seg_applied = False
        if self.enable_segmentation:
            embed_fn = policy.get("embed_fn") or self.embedder
            ctx = segment_context(
                ctx_before,
                strategy=self.segmentation_strategy,
                embed_fn=embed_fn,
                sim_threshold=self.segmentation_sim_threshold,
            )
            seg_applied = True

        sent_idx = 0
        doc_titles: List[str] = []
        for title, sentences in ctx:
            if title not in doc_titles:
                doc_titles.append(title)
            for j, sent in enumerate(sentences):
                if title != "default":
                    node_id, sid = f"{title}::sent{j}", j
                else:
                    node_id, sid = f"sent{sent_idx}", sent_idx
                nodes.append(GraphNode(
                    id=node_id, type="sentence", text=sent,
                    meta={"doc": title, "sent_id": sid, "source": "context"},
                ))
                sent_idx += 1

        if self.use_doc_nodes:
            for title in doc_titles:
                nodes.append(GraphNode(id=f"doc::{title}", type="document",
                                       text=title, meta={"source": "context"}))

        entity_count = 0
        if self.use_entity_nodes:
            sent_texts = [n.text for n in nodes if n.type == "sentence"]
            entity_set = set()
            for t in sent_texts:
                entity_set.update(capitalized_runs(t or ""))
            for ent in elq_link_entities(" ".join(sent_texts)):
                if ent.get("text"):
                    entity_set.add(ent["text"])
            for e in sorted(entity_set):
                nodes.append(GraphNode(id=f"ent::{e.replace(' ', '_')}",
                                       type="entity", text=e,
                                       meta={"source": "linker"}))
                entity_count += 1

        self.last_diagnostics = {
            "segment": {
                "enabled": seg_applied,
                "strategy": self.segmentation_strategy if seg_applied else None,
                "sim_threshold": self.segmentation_sim_threshold if seg_applied else None,
                "sent_count_before": sum(len(s) for _, s in ctx_before),
                "sent_count_after": sum(len(s) for _, s in ctx),
            },
            "node_counts": {
                "question": 1 if question else 0,
                "document": len(doc_titles) if self.use_doc_nodes else 0,
                "sentence": sent_idx,
                "entity": entity_count,
            },
        }
        return nodes
