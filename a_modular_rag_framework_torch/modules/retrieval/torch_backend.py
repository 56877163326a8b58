"""TorchHybridRetrievalBackend: the production retriever (port of
``a_modular_rag_framework_tpu/modules/retrieval/tpu_backend.py``).

LLM query expansion -> BM25 pool -> graph expansion -> dense rerank ->
per-channel min-max norm -> alpha fusion -> top-k, returning `RetrievalOut`
hits with ``sent::<doc>::<sid>`` ids and channel-norm metadata.

The pool, graph, dense and fusion steps run as one device program inside
`TorchQueryEngine`; this class is the thin host adapter that (a) expands
the query via the router, (b) maps the per-question graph's q_match seeds
to corpus rows (parity mode) or lets the engine derive weighted seeds from
BM25 (corpus mode), and (c) hydrates the returned ``(ids, scores)`` arrays
into `Hit` objects.

The packed index is built once from docs.jsonl and cached on disk next to
it (``<docs>.packed/``); later constructions load it from there instead of
re-indexing. Both packages share that layout: a directory written by either
loads in the other.

The backend, its engine and its learned models live on ``device``: the
card unless the caller says otherwise; asking for CUDA where there is none
raises. ``mesh_axes`` (the settings' ``mesh.axes``) over the visible
devices of ``device``'s kind that put more than one position on
``shard_axis`` select `parallel.sharded_hybrid.ShardedHybridEngine`; a mesh
that does not fit the devices is warned about and served on one device.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..._host import require_device
from ...core.dto import Hit, HitBatch, RetrievalIn, RetrievalOut
from ...core.llm_router import LLMRouter
from ...engine.query_engine import (EngineConfig, QueryResult,
                                    TorchQueryEngine)
from ...index.builder import build_packed_index
from ...index.corpus import SentenceCorpus
from ...index.packed import PackedIndex
from ...parallel.mesh import build_mesh, mesh_devices, visible_devices
from ...telemetry.sinks import TelemetrySink, record_metrics, span
from .query_expander import LLMQueryExpander

logger = logging.getLogger(__name__)


def load_or_build_packed_index(
    index_path: str,
    *,
    embed_dim: int = 64,
    embed_dtype: str = "bfloat16",
    encoder: Optional[Any] = None,
    cache: bool = True,
    index_titles: bool = False,
) -> PackedIndex:
    """Load the cached packed artifact for docs.jsonl, or build + cache it.

    ``index_titles`` (natural-discourse corpora: prepend doc titles to the
    indexed text, see builder.build_packed_index) participates in cache
    validity — a cached artifact built under the other setting is rebuilt.
    """
    docs_path = Path(index_path)
    packed_dir = docs_path.with_suffix(docs_path.suffix + ".packed")
    if cache and (packed_dir / "manifest.json").exists():
        try:
            idx = PackedIndex.load(packed_dir)
            built_titled = bool((idx.manifest.get("build_stats") or {})
                                .get("index_titles"))
            if (idx.embed_dim == embed_dim and idx.embed_dtype == embed_dtype
                    and built_titled == bool(index_titles)):
                return idx
        except Exception as e:
            logger.warning("packed index reload failed (%r); rebuilding", e)
    corpus = SentenceCorpus.from_jsonl(docs_path)
    return build_packed_index(
        corpus, encoder=encoder, embed_dim=embed_dim, embed_dtype=embed_dtype,
        index_titles=bool(index_titles),
        out_dir=str(packed_dir) if (cache and len(corpus)) else None,
    )


class TorchHybridRetrievalBackend:
    def __init__(
        self,
        router: Optional[LLMRouter] = None,
        sink: Optional[TelemetrySink] = None,
        *,
        index_path: str = "data/hotpotqa/docs.jsonl",
        graph_root: str = "data/graph",
        bm25_k1: float = 1.5,
        bm25_b: float = 0.75,
        graph_window: int = 2,
        alpha_text: float = 0.4,
        alpha_graph: float = 0.2,
        alpha_dense: float = 0.4,
        order_alphas: Any = None,
        bm25_pool_k: int = 200,
        default_top_k: int = 20,
        qe_lines: int = 3,
        qe_attr_paraphrase: bool = True,
        embed_batch: int = 1024,
        embed_dim: int = 64,
        embed_dtype: str = "bfloat16",
        encoder: Optional[Any] = None,
        index: Optional[PackedIndex] = None,
        engine: Optional[TorchQueryEngine] = None,
        use_pallas: Any = "auto",
        include_entity_graph: bool = True,
        graph_seed_weighted: bool = True,
        bm25_impl: str = "sorted",
        bm25_term_topm: int = 128,
        fusion_impl: str = "compact",
        batch_buckets: Any = (1, 8, 64, 256),
        iterative_hops: int = 2,
        hop_decay: float = 0.5,
        encoder_weights: str = "",
        encoder_layers: int = 2,
        encoder_subword_ngrams: int = 8,
        mesh_axes: Optional[Dict[str, int]] = None,
        shard_axis: str = "data",
        query_df_ratio_max: float = 0.0,
        graph_impl: str = "auto",
        graph_compact_cap: int = 256,
        graph_wave_dtype: str = "float32",
        cross_rerank_weights: str = "",
        cross_rerank_top_m: int = 20,
        cross_rerank_subword_ngrams: int = 8,
        sparse_impl: str = "bm25",
        splade_weights: str = "",
        index_titles: bool = False,
        device="cuda",
    ):
        # an injected engine brings its device with it
        self.device = (engine.device if engine is not None
                       else require_device(device))
        self.router = router
        self.sink = sink
        self.graph_root = graph_root
        self.default_top_k = int(default_top_k)
        self.graph_window = int(graph_window)
        self.embed_batch = int(embed_batch)
        # iterative_hops >= 2 enables bridge-entity hop-2 reformulation
        # (modules.retrieval.multihop); costs one extra engine batch
        self.iterative_hops = int(iterative_hops)
        self.hop_decay = float(hop_decay)

        self.expander = LLMQueryExpander(router, qe_lines, qe_attr_paraphrase)
        self._ephemeral_cache: Dict[str, TorchQueryEngine] = {}

        # optional second stage: joint (query, passage) cross-encoder over
        # the fused top-m. Off unless weights are configured.
        self.reranker = None
        self.cross_rerank_top_m = int(cross_rerank_top_m)
        if cross_rerank_weights:
            from ...models.cross_encoder import (
                CrossEncoderConfig,
                CrossEncoderReranker,
            )

            self.reranker = CrossEncoderReranker.load(
                cross_rerank_weights,
                CrossEncoderConfig(
                    subword_ngrams=int(cross_rerank_subword_ngrams)),
                device=self.device)

        if encoder is None and encoder_weights:
            # learned TextEncoder with fastText-style char-ngram subword
            # features: unseen surnames share most buckets with trained
            # syllable-mates, so the encoder transfers across entity
            # vocabularies
            from ...models.encoder import EncoderConfig, TextEncoder

            cfg_enc = EncoderConfig(d_model=embed_dim, n_layers=encoder_layers,
                                    subword_ngrams=encoder_subword_ngrams)
            encoder = TextEncoder.load(encoder_weights, cfg_enc,
                                       device=self.device)

        # coupled knobs: the narrow phase-1 postings window is only safe
        # when idf pruning keeps query terms rare (measured: topm=32 loses
        # recall 0.47 -> 0.41 unpruned, is recall-neutral pruned)
        if not query_df_ratio_max and int(bm25_term_topm) < 128:
            logger.warning(
                "bm25_term_topm=%d with query pruning OFF loses recall "
                "(see docs/DESIGN.md); raise it to >=128 or set "
                "query_df_ratio_max", bm25_term_topm)

        if engine is not None:
            self.engine = engine
        else:
            if index is None:
                index = load_or_build_packed_index(
                    index_path, embed_dim=embed_dim, embed_dtype=embed_dtype,
                    encoder=encoder, index_titles=index_titles,
                )
            config = EngineConfig(
                top_k=default_top_k,
                pool_k=bm25_pool_k,
                qe_variants=1 + int(qe_lines),
                graph_window=graph_window,
                alpha_text=alpha_text,
                alpha_graph=alpha_graph,
                alpha_dense=alpha_dense,
                order_alphas=(tuple(order_alphas) if order_alphas
                              else None),
                include_entity_graph=include_entity_graph,
                graph_seed_weighted=graph_seed_weighted,
                bm25_impl=bm25_impl,
                bm25_term_topm=bm25_term_topm,
                fusion_impl=fusion_impl,
                batch_buckets=tuple(batch_buckets),
                query_df_ratio_max=float(query_df_ratio_max),
                graph_impl=str(graph_impl),
                graph_compact_cap=int(graph_compact_cap),
                graph_wave_dtype=str(graph_wave_dtype),
                sparse_impl=str(sparse_impl),
                splade_weights=str(splade_weights),
            )
            # learned-sparse text channel: the corpus expansion is cached
            # next to the packed index so re-inits load it instead of
            # re-running the expansion model
            splade_index = None
            splade_cache = None
            if sparse_impl == "splade":
                from ...ops.splade import SpladeDeviceIndex

                if query_df_ratio_max:
                    logger.info("sparse_impl=splade: idf query pruning is "
                                "inert (the expansion head owns weighting)")
                packed_dir = Path(index_path).with_suffix(
                    Path(index_path).suffix + ".packed")
                if packed_dir.is_dir():
                    splade_cache = packed_dir / "splade_index.npz"
                    if splade_cache.exists():
                        try:
                            splade_index = SpladeDeviceIndex.load(
                                str(splade_cache))
                        except Exception as e:
                            logger.warning(
                                "splade index cache reload failed (%r); "
                                "re-expanding", e)
            if mesh_axes and sparse_impl == "splade":
                logger.warning("sparse_impl=splade is single-device; "
                               "ignoring mesh_axes %r", mesh_axes)
                mesh_axes = None
            self.engine = None
            if mesh_axes:
                # settings `mesh:` wiring: more than one position on the
                # shard axis serves through the sharded hybrid engine (BM25,
                # graph and dense rows split over the axis)
                try:
                    mesh = build_mesh(dict(mesh_axes), devices=mesh_devices(
                        self.device, visible_devices(self.device)))
                except ValueError as e:
                    logger.warning("mesh %r unavailable (%s); single-device",
                                   mesh_axes, e)
                    mesh = None
                if mesh is not None and mesh.shape.get(shard_axis, 1) > 1:
                    from ...parallel.sharded_hybrid import ShardedHybridEngine

                    self.engine = ShardedHybridEngine(
                        index, mesh=mesh, axis=shard_axis, encoder=encoder,
                        config=config, sink=sink)
                    logger.info("sharded hybrid engine: %d shards over %r",
                                self.engine.n_shards, shard_axis)
            if self.engine is None:
                self.engine = TorchQueryEngine(
                    index, device=self.device, encoder=encoder,
                    config=config, sink=sink, splade_index=splade_index)
            if (splade_cache is not None and not splade_cache.exists()
                    and self.engine._splade_index is not None):
                try:
                    self.engine._splade_index.save(str(splade_cache))
                except Exception as e:  # pragma: no cover
                    logger.warning("splade index cache write failed: %r", e)

    # ---- per-question graph seeds ----

    def _graph_seed_rows(self, graph_id: str, engine=None) -> Optional[List[int]]:
        """Map the per-question graph's q_match sentence nodes to corpus rows.

        Sentence node ids are ``{doc}::sent{j}``; the corpus row is looked
        up by (doc title, sent_id) against the serving engine's corpus
        (the ephemeral graph-sentence corpus in fallback mode). Returns
        None when no graph is available (the engine then derives weighted
        BM25 seeds)."""
        if not graph_id:
            return None
        gdir = Path(self.graph_root) / graph_id
        adj = gdir / "adjacency.npz"
        rows: List[int] = []
        by = (engine or self.engine).index.corpus.row_by_title_sid()
        try:
            use_json = not adj.exists()
            if not use_json:
                try:
                    data = np.load(adj, allow_pickle=False)
                    node_ids = list(data["node_ids"])
                    for seed in data["qmatch_seeds"]:
                        nid = str(node_ids[int(seed)])
                        row = self._node_id_to_row(nid, by)
                        if row is not None:
                            rows.append(row)
                except ValueError:
                    # pre-round-2 artifact: node_ids saved as dtype=object
                    # needs pickle, which we refuse for untrusted dirs.
                    # graph.json carries the same q_match edges — use it
                    # and suggest re-ingesting.
                    logger.warning(
                        "legacy adjacency.npz for %s (object-dtype "
                        "node_ids); reading graph.json instead — re-ingest "
                        "to refresh the artifact", graph_id)
                    use_json = True
            if use_json:
                gj = gdir / "graph.json"
                if not gj.exists():
                    return sorted(set(rows)) if rows else None
                g = json.loads(gj.read_text(encoding="utf-8"))
                for e in g.get("edges", []):
                    if e.get("type") == "q_match" and e.get("source") == "q1":
                        row = self._node_id_to_row(str(e.get("target")), by)
                        if row is not None:
                            rows.append(row)
        except Exception as e:
            logger.warning("graph seed load failed for %s: %r", graph_id, e)
            return None
        return sorted(set(rows)) if rows else None

    @staticmethod
    def _node_id_to_row(node_id: str, by_title_sid: Dict) -> Optional[int]:
        if "::sent" not in node_id:
            return None
        doc, _, sid = node_id.rpartition("::sent")
        try:
            return by_title_sid.get((doc, int(sid)))
        except ValueError:
            return None

    # ---- empty-corpus fallback: per-question graph as the corpus ----

    def _ephemeral_engine(self, graph_id: str):
        """When no corpus was ever ingested (index empty), the per-question
        graph built moments earlier from the question's context IS the
        available evidence — serve retrieval from its sentence nodes via a
        small throwaway engine (the reference in the same situation
        returned nothing, BM25LiteIndex over a missing docs.jsonl).
        Cached per graph_id (bounded)."""
        if not graph_id:
            return None
        cached = self._ephemeral_cache.get(graph_id)
        if cached is not None:
            return cached
        gj = Path(self.graph_root) / graph_id / "graph.json"
        if not gj.exists():
            return None
        try:
            g = json.loads(gj.read_text(encoding="utf-8"))
        except Exception:
            return None
        docs = []
        for nd in g.get("nodes", []):
            if nd.get("type") == "sentence" and nd.get("text"):
                nid = str(nd.get("id") or "")
                doc, _, sid = nid.rpartition("::sent")
                try:
                    sid_i = int(sid)
                except ValueError:
                    continue
                docs.append({"doc_id": f"{doc}#{sid_i}", "title": doc,
                             "sent_id": sid_i, "text": nd["text"]})
        if not docs:
            return None
        corpus = SentenceCorpus(docs=docs)
        base = self.engine.config
        idx = build_packed_index(
            corpus, encoder=self.engine.encoder,
            embed_dim=self.engine.index.embed_dim or 64,
            embed_dtype="float32",
        )
        eng = TorchQueryEngine(
            idx, device=self.device, encoder=self.engine.encoder,
            config=EngineConfig(
                top_k=base.top_k, pool_k=min(base.pool_k, idx.n_docs),
                graph_window=base.graph_window,
                alpha_text=base.alpha_text, alpha_graph=base.alpha_graph,
                alpha_dense=base.alpha_dense,
                order_alphas=base.order_alphas, batch_buckets=(1, 8),
            ),
            sink=self.sink,
        )
        if len(self._ephemeral_cache) >= 8:
            self._ephemeral_cache.pop(next(iter(self._ephemeral_cache)))
        self._ephemeral_cache[graph_id] = eng
        return eng

    # ---- main ----

    def run(self, req: RetrievalIn) -> Dict[str, Any]:
        trace_id = req.trace_id or "trace-demo"
        top_k = int(req.top_k or self.default_top_k)

        with span("Backend/Expand", self.sink, trace_id):
            expanded = self.expander.expand(query=req.query, trace_id=trace_id)
            queries = [req.query] + expanded

        engine = self.engine
        fallback = None
        if getattr(engine, "_n", engine.index.n_docs) == 0:
            eph = self._ephemeral_engine(req.graph_id or "")
            if eph is not None:
                engine = eph
                fallback = "graph_sentences"

        with span("Backend/GraphSeeds", self.sink, trace_id):
            seeds = self._graph_seed_rows(req.graph_id or "", engine=engine)

        gw = req.graph_window if isinstance(req.graph_window, int) else None
        window = gw if gw is not None else self.graph_window
        with span("Backend/EngineQuery", self.sink, trace_id):
            if self.iterative_hops >= 2:
                from .multihop import iterative_retrieve

                ids, scores, norms, diag = iterative_retrieve(
                    engine, [req.query],
                    top_k=top_k,
                    hop_decay=self.hop_decay,
                    expansions=[expanded],
                    seed_rows=[seeds] if seeds is not None else None,
                    graph_window=window,
                    trace_id=trace_id,
                )
                result = QueryResult(
                    hits=HitBatch(ids=ids, scores=scores),
                    channel_norms=np.moveaxis(norms, 1, 0),
                    diagnostics=diag,
                )
            else:
                result = engine.query_batch(
                    [req.query],
                    expansions=[expanded],
                    seed_rows=[seeds] if seeds is not None else None,
                    top_k=top_k,
                    graph_window=window,
                    trace_id=trace_id,
                )
            hits = engine.hydrate_hits(result, 0)

        if self.reranker is not None and hits:
            with span("Backend/CrossRerank", self.sink, trace_id):
                texts = [str(h.meta.get("text", "")) for h in hits]
                scores = self.reranker.score_pairs(
                    [req.query] * min(self.cross_rerank_top_m, len(hits)),
                    texts[: self.cross_rerank_top_m])
                order = sorted(range(len(scores)),
                               key=lambda i: (-scores[i], i))
                order += list(range(len(scores), len(hits)))
                hits = [hits[i] for i in order]
                for rank, i in enumerate(order[: len(scores)]):
                    hits[rank].meta["cross_score"] = float(scores[i])

        diagnostics = {
            "queries": queries,
            **result.diagnostics,
            **({"fallback": fallback} if fallback else {}),
            "seed_mode": "qmatch" if seeds is not None else "bm25_weighted",
            **({"cross_reranked": self.cross_rerank_top_m}
               if self.reranker is not None else {}),
            "seed_count": len(seeds) if seeds else 0,
            "resolved_embed_model": (
                self.router.resolve_embed_model() if self.router else "torch-hash-encoder"
            ),
        }
        if self.sink:
            record_metrics(self.sink, trace_id, retrieval={
                "hits": len(hits),
                "device_ms": result.diagnostics.get("device_ms"),
                "seed_mode": diagnostics["seed_mode"],
            })
        return {"hits": [h.model_dump() for h in hits], "diagnostics": diagnostics}

    def retrieve(self, req: RetrievalIn) -> RetrievalOut:
        out = self.run(req)
        return RetrievalOut(
            hits=[Hit(**h) for h in out["hits"]],
            diagnostics=out["diagnostics"],
        )
