"""Index build: corpus -> hash embeddings + BM25 CSR + sentence graph.

Port of ``a_modular_rag_framework_tpu/index/builder.py``: the same tables
from the same corpus, array for array. Everything here runs on the host
(native C++ stages when their library builds, Python otherwise); the
device sees the result through `PackedIndex.device_*`.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..models.hash_embed import HashEmbedEncoder
from ..native import binding as _native
from ..utils.entity_linker import simple_ner
from .bm25 import Bm25Index
from .packed import PackedIndex


def build_sentence_graph(corpus, max_degree: int = 32,
                         entity_chain_cap: int = 64,
                         texts: Optional[List[str]] = None,
                         ) -> Dict[str, np.ndarray]:
    """Two adjacency tables, each [N, deg] int32 (-1 pad):

      - ``next_in_doc`` [N, 2]: (title, sid) <-> (title, sid+1) chains;
      - ``entity`` [N, max_degree]: sentences naming the same proper-noun
        span, linked to the entity's first row (hub) plus a consecutive
        chain, in first-appearance order.

    ``texts`` overrides the per-row text used for entity extraction only.
    """
    n = len(corpus)
    next_nbrs = np.full((n, 2), -1, dtype=np.int32)
    next_counts = np.zeros(n, dtype=np.int32)
    by_title_sid = corpus.row_by_title_sid()
    for row, d in enumerate(corpus.docs):
        nxt = by_title_sid.get((d.get("title"), (d.get("sent_id") or 0) + 1))
        if nxt is None or nxt == row:
            continue
        ca = int(next_counts[row])
        if ca < 2 and (ca == 0 or int(next_nbrs[row, 0]) != nxt):
            next_nbrs[row, ca] = nxt
            next_counts[row] = ca + 1
        cb = int(next_counts[nxt])
        if cb < 2 and (cb == 0 or int(next_nbrs[nxt, 0]) != row):
            next_nbrs[nxt, cb] = row
            next_counts[nxt] = cb + 1

    ent_texts = (texts if texts is not None
                 else [d.get("text", "") for d in corpus.docs])
    ent_nbrs = _native.entity_graph_native(
        ent_texts, max_degree=max_degree, entity_chain_cap=entity_chain_cap)
    if ent_nbrs is None:
        ent_nbrs = _entity_graph_python(ent_texts, max_degree,
                                        entity_chain_cap)
    return {"next_in_doc": next_nbrs, "entity": ent_nbrs}


def _entity_graph_python(texts: List[str], max_degree: int,
                         entity_chain_cap: int) -> np.ndarray:
    n = len(texts)
    nbrs = np.full((n, max_degree), -1, dtype=np.int32)
    counts = np.zeros(n, dtype=np.int32)

    def add(a: int, b: int) -> None:
        if a == b:
            return
        if counts[a] < max_degree and b not in nbrs[a, : counts[a]]:
            nbrs[a, counts[a]] = b
            counts[a] += 1
        if counts[b] < max_degree and a not in nbrs[b, : counts[b]]:
            nbrs[b, counts[b]] = a
            counts[b] += 1

    entity_rows: Dict[str, List[int]] = {}
    for row, row_text in enumerate(texts):
        # ordered dedup (not set()): reproducible across processes
        for ent in dict.fromkeys(simple_ner(row_text)):
            lst = entity_rows.setdefault(ent, [])
            if len(lst) < entity_chain_cap:
                lst.append(row)
    for rows in entity_rows.values():
        hub = rows[0]
        for r in rows[1:]:
            add(hub, r)
        for a, b in zip(rows, rows[1:]):
            add(a, b)
    return nbrs


def build_packed_index(
    corpus,
    *,
    encoder: Optional[Any] = None,
    embed_dim: int = 64,
    embed_dtype: str = "bfloat16",
    embed_batch: int = 65536,
    bm25_k1: float = 1.5,
    bm25_b: float = 0.75,
    bm25_phrase_tokens: bool = True,
    graph_max_degree: int = 32,
    index_titles: bool = False,
    out_dir: Optional[str] = None,
) -> PackedIndex:
    """Build the index on the host; optionally persist to ``out_dir``.

    ``index_titles`` prepends each sentence's document title to the text
    every channel indexes (hit ids and doc adjacency are unaffected)."""
    encoder = encoder or HashEmbedEncoder(dim=embed_dim)
    texts = corpus.texts()
    if index_titles:
        texts = [f"{d.get('title') or ''} . {t}" if d.get("title") else t
                 for d, t in zip(corpus.docs, texts)]
    n = len(texts)
    t0 = time.time()
    shards = [encoder.encode_texts(texts[i: i + embed_batch])
              for i in range(0, n, embed_batch)]
    emb = (np.concatenate(shards, axis=0).astype(np.float32, copy=False)
           if shards else np.zeros((0, embed_dim), np.float32))
    t_embed = time.time() - t0

    t1 = time.time()
    bm25 = Bm25Index.build(texts, k1=bm25_k1, b=bm25_b,
                           phrase_tokens=bm25_phrase_tokens)
    t_bm25 = time.time() - t1
    t2 = time.time()
    graph_tables = build_sentence_graph(
        corpus, max_degree=graph_max_degree,
        texts=texts if index_titles else None)
    t_graph = time.time() - t2

    total = time.time() - t0
    idx = PackedIndex(
        corpus=corpus, embeddings=emb, embed_dtype=embed_dtype, bm25=bm25,
        graph_next=graph_tables["next_in_doc"],
        graph_entity=graph_tables["entity"],
        manifest={"build_stats": {
            "passages": n,
            "index_titles": bool(index_titles),
            "total_sec": round(total, 3),
            "embed_sec": round(t_embed, 3),
            "bm25_sec": round(t_bm25, 3),
            "graph_sec": round(t_graph, 3),
            "passages_per_sec": round(n / total, 1) if total > 0 else 0.0,
        }},
    )
    if out_dir:
        idx.save(out_dir)
    return idx
