"""Request adapters: v1 -> v2 upgrade and HotpotQA context -> v2 graph.

The port's copy of ``a_modular_rag_framework_tpu/adapters/graph_request_adapter.py``,
over the port's pydantic-free `schemas.graph_request_v2`: ``upgrade_to_v2``
lifts legacy requests, ``hotpotqa_to_v2`` converts raw HotpotQA context
into nodes / edges / sentences with q2doc / doc2sent / next_sent edge kinds.
"""
from __future__ import annotations

import re
import uuid
from typing import Any, Dict, List

from ..schemas.graph_request_v2 import AssembleGraphRequestV2, Inputs, Sentence


def normalize_title(title: str) -> str:
    """Title -> id fragment: trimmed, non-word chars collapsed to '_'."""
    return re.sub(r"\W+", "_", (title or "").strip())


def upgrade_to_v2(raw: Dict[str, Any], *, default_trace_id: str) -> AssembleGraphRequestV2:
    raw_inputs = raw.get("inputs") or {}
    nodes = raw_inputs.get("nodes", raw.get("nodes", [])) or []
    edges = raw_inputs.get("edges", raw.get("edges", [])) or []

    sents = raw_inputs.get("sentences") or raw.get("sentences")
    if sents is None and "question" in raw:
        sents = [raw["question"]]

    sentences: List[Sentence] = []
    if isinstance(sents, list):
        sentences = [Sentence(id=f"sent:{i}", text=str(t)) for i, t in enumerate(sents)]
    elif isinstance(sents, str):
        sentences = [Sentence(id="sent:0", text=sents)]

    graph_id = raw.get("graph_id") or f"graph-{default_trace_id}-{uuid.uuid4().hex[:8]}"
    return AssembleGraphRequestV2(
        graph_id=graph_id,
        inputs=Inputs(sentences=sentences, nodes=list(nodes), edges=list(edges)),
    )


def hotpotqa_to_v2(external_context: Dict[str, Any], trace_id: str = "trace-demo") -> AssembleGraphRequestV2:
    """HotpotQA ``{"context": [[title, [sents]], ...]}`` -> v2 request with
    question/doc/sentence nodes and q2doc / doc2sent / next_sent edges."""
    graph_id = f"graph-{trace_id}-{uuid.uuid4().hex[:8]}"
    context = external_context.get("context", [])

    nodes: List[Dict[str, Any]] = []
    edges: List[Dict[str, Any]] = []
    sentences: List[Sentence] = []

    q_node_id = "question:0"
    nodes.append({"id": q_node_id, "label": "__USER_QUESTION__", "kind": "question"})
    sentences.append(Sentence(id=q_node_id, text="__USER_QUESTION__"))

    for doc_title, sents in context:
        doc_id = f"doc:{normalize_title(doc_title)}"
        nodes.append({"id": doc_id, "label": doc_title, "kind": "doc"})
        edges.append({"source": q_node_id, "target": doc_id, "type": "directed",
                      "kind": "q2doc", "label": "q2doc"})
        prev_id = None
        for sent_idx, text in enumerate(sents):
            sent_id = f"{doc_id}::sent{sent_idx}"
            nodes.append({"id": sent_id, "label": text, "kind": "sentence"})
            sentences.append(Sentence(id=sent_id, text=text))
            edges.append({"source": doc_id, "target": sent_id, "type": "directed",
                          "kind": "doc2sent", "label": "doc2sent"})
            if prev_id is not None:
                edges.append({"source": prev_id, "target": sent_id,
                              "type": "directed", "kind": "next_sent",
                              "label": "next_sent"})
            prev_id = sent_id

    return AssembleGraphRequestV2(
        graph_id=graph_id,
        inputs=Inputs(sentences=sentences, nodes=nodes, edges=edges),
    )
