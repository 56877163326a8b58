"""Per-question graph store: load persisted graphs and expand neighborhoods.

The port of ``a_modular_rag_framework_tpu/modules/retrieval/graph_store.py``:
reads the same ``graph.json`` shape (written by `impl_arrays` here or by
the reference's networkx implementation), builds next_in_doc forward /
backward adjacency + the q_match seed list, and runs hop-decay BFS
expansion through `ops.graph.expand_frontier`, the op the corpus-scale
engine uses. `expand_qmatch_neighbors` runs it on ``device``: the card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..._host import require_device, to_device
from ...ops.graph import expand_frontier, hop_decay_table


def load_graph_json(graph_root: str, graph_id: str) -> Dict[str, Any]:
    """Read data/graph/<graph_id>/graph.json; empty graph when missing."""
    p = Path(graph_root) / graph_id / "graph.json"
    if not p.exists():
        return {"nodes": [], "edges": []}
    return json.loads(p.read_text(encoding="utf-8"))


def build_index(graph: Dict[str, Any]):
    """-> (nodes_by_id, next_forward, next_backward, node_texts, q_to_sent).

    ``node_texts`` reads sentence text from the top-level ``text`` attr with
    a ``props.text`` fallback — covering both this framework's graphs and
    props-style graphs (the reference read only props and silently lost its
    own pipeline's texts, SURVEY.md §2 quirk 3; we fix that here)."""
    nodes = graph.get("nodes", [])
    edges = graph.get("edges", [])

    nodes_by_id = {n["id"]: n for n in nodes}
    next_forward: Dict[str, List[str]] = {}
    next_backward: Dict[str, List[str]] = {}
    node_texts: Dict[str, str] = {}
    q_to_sent: List[str] = []

    for n in nodes:
        if n.get("type") == "sentence":
            text = n.get("text")
            if not text:
                props = n.get("props")
                if isinstance(props, str):
                    try:
                        props = json.loads(props)
                    except json.JSONDecodeError:
                        props = {}
                text = (props or {}).get("text", "") if isinstance(props, dict) else ""
            node_texts[n["id"]] = str(text or "")

    for e in edges:
        et = e.get("type")
        s, t = e.get("source"), e.get("target")
        if et == "next_in_doc":
            next_forward.setdefault(s, []).append(t)
            next_backward.setdefault(t, []).append(s)
        elif et == "q_match" and s == "q1":
            q_to_sent.append(t)

    return nodes_by_id, next_forward, next_backward, node_texts, q_to_sent


def _meta_of(node: Dict[str, Any]) -> Dict[str, Any]:
    meta = node.get("meta")
    if isinstance(meta, str):
        try:
            meta = json.loads(meta)
        except json.JSONDecodeError:
            meta = {}
    return meta if isinstance(meta, dict) else {}


def expand_qmatch_neighbors(
    q_text: str,
    nodes_by_id: Dict[str, Dict[str, Any]],
    next_forward: Dict[str, List[str]],
    next_backward: Dict[str, List[str]],
    node_texts: Dict[str, str],
    explicit_qmatch: Optional[List[str]] = None,
    window: int = 1,
    device="cuda",
) -> Dict[str, Tuple[float, Dict[str, Any]]]:
    """Hop-decay BFS from q_match seeds -> {sent_id: (score, meta)}.

    Seeds fall back to token-overlap matching when no explicit q_match edges
    exist. The BFS + decay run as one `expand_frontier` call on ``device``
    over the packed adjacency of the (small) per-question graph.
    """
    dev = require_device(device)
    from ...models.hash_embed import tokenize

    sent_ids = sorted(node_texts.keys())
    row_of = {sid: i for i, sid in enumerate(sent_ids)}
    n = len(sent_ids)
    if n == 0:
        return {}

    seeds = [s for s in (explicit_qmatch or []) if s in row_of]
    if not seeds:
        q_terms = set(tokenize(q_text))
        seeds = [sid for sid in sent_ids
                 if node_texts.get(sid) and (q_terms & set(tokenize(node_texts[sid])))]
    if not seeds:
        return {}

    max_deg = 1
    adj_lists: List[List[int]] = [[] for _ in range(n)]
    for sid, outs in next_forward.items():
        if sid not in row_of:
            continue
        for t in outs:
            if t in row_of:
                adj_lists[row_of[sid]].append(row_of[t])
                adj_lists[row_of[t]].append(row_of[sid])
    max_deg = max((len(a) for a in adj_lists), default=1) or 1
    nbrs = np.full((n, max_deg), -1, dtype=np.int32)
    for i, a in enumerate(adj_lists):
        nbrs[i, : len(a)] = a[:max_deg]

    seed_mask = np.zeros(n, dtype=bool)
    seed_mask[[row_of[s] for s in seeds]] = True
    scores, _ = expand_frontier(to_device(nbrs, dev), to_device(seed_mask, dev),
                                window=max(0, window))
    scores = scores.cpu().numpy()

    out: Dict[str, Tuple[float, Dict[str, Any]]] = {}
    for i, sid in enumerate(sent_ids):
        sc = float(scores[i])
        if sc <= 0:
            continue
        node = nodes_by_id.get(sid, {})
        meta = {
            "kind": "sentence",
            "text": node_texts.get(sid, ""),
            "doc": _meta_of(node).get("doc"),
        }
        out[sid] = (sc, meta)
    return out
