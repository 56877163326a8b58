"""Retrieval flow adapter (port of
``a_modular_rag_framework_tpu/modules/retrieval/flow.py``).

Two modes: an injected backend (the hybrid engine in production), or a
built-in pipeline Expand -> RetrieveText -> GraphExpand -> RankSelect that
also rides the device engine with its default fusion. Both run on
``device``: the card unless the settings or the caller say otherwise.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np

from ...core.dto import Hit, RetrievalIn, RetrievalOut
from ...core.llm_router import LLMRouter
from ...di.factory import filtered_kwargs, import_from_string
from ...telemetry.sinks import TelemetrySink, span
from .query_expander import LLMQueryExpander

logger = logging.getLogger(__name__)


class RetrievalAgentFlow:
    def __init__(
        self,
        router: Optional[LLMRouter] = None,
        *,
        id_keys: Optional[List[str]] = None,
        score_keys: Optional[List[str]] = None,
        index_path: str = "data/hotpotqa/docs.jsonl",
        graph_root: str = "data/graph",
        bm25_k1: float = 1.5,
        bm25_b: float = 0.75,
        graph_window: int = 1,
        alpha_text: float = 0.7,
        alpha_graph: float = 0.3,
        backend: Any = None,
        sink: Optional[TelemetrySink] = None,
        engine: Any = None,
        device="cuda",
    ):
        self.device = device
        self.router = router
        self.sink = sink
        self.backend = backend
        self.id_keys = id_keys or ["id", "doc_id", "docId", "sid", "sent_id"]
        self.score_keys = score_keys or ["score", "relevance", "sim", "s"]
        self.index_path = index_path
        self.graph_root = graph_root
        self.graph_window = max(0, int(graph_window))
        self.alpha_text = float(alpha_text)
        self.alpha_graph = float(alpha_graph)
        self._engine = engine
        self._expander = LLMQueryExpander(router, lines=2) if router else None

    @classmethod
    def from_settings(
        cls,
        settings: Dict[str, Any],
        router: Optional[LLMRouter] = None,
        sink: Optional[TelemetrySink] = None,
        engine: Any = None,
    ) -> "RetrievalAgentFlow":
        cfg = (settings.get("modules", {}) or {}).get("retrieval", {}) or {}
        flow_kwargs = dict(cfg.get("kwargs") or {})

        backend = None
        impl_spec = cfg.get("impl")
        if impl_spec:
            impl_cls = import_from_string(impl_spec)
            raw_kwargs = dict(cfg.get("impl_kwargs") or {})
            # top-level sections feed backend defaults (module-level
            # impl_kwargs win): index -> embed dim/dtype/capacities,
            # kernels -> kernel toggle and batch buckets, device
            index_cfg = settings.get("index") or {}
            for src_key, dst_key in (("embed_dim", "embed_dim"),
                                     ("dtype", "embed_dtype"),
                                     ("max_postings_per_term", "bm25_term_topm"),
                                     ("query_df_ratio_max", "query_df_ratio_max"),
                                     ("graph_impl", "graph_impl"),
                                     ("graph_compact_cap", "graph_compact_cap"),
                                     ("graph_wave_dtype", "graph_wave_dtype")):
                if src_key in index_cfg:
                    raw_kwargs.setdefault(dst_key, index_cfg[src_key])
            kernels_cfg = settings.get("kernels") or {}
            if "use_pallas" in kernels_cfg:
                raw_kwargs.setdefault("use_pallas", kernels_cfg["use_pallas"])
            if "query_batch_buckets" in kernels_cfg:
                raw_kwargs.setdefault("batch_buckets",
                                      kernels_cfg["query_batch_buckets"])
            # mesh -> sharded hybrid serving (multi-device index sharding)
            mesh_cfg = settings.get("mesh") or {}
            if mesh_cfg.get("axes"):
                raw_kwargs.setdefault("mesh_axes", dict(mesh_cfg["axes"]))
            if "shard_axis" in index_cfg:
                raw_kwargs.setdefault("shard_axis", index_cfg["shard_axis"])
            if settings.get("device"):
                raw_kwargs.setdefault("device", settings["device"])
            impl_kwargs = filtered_kwargs(
                impl_cls, raw_kwargs,
                inject={"router": router, "sink": sink, "engine": engine},
            )
            backend = impl_cls(**impl_kwargs)

        if settings.get("device"):
            flow_kwargs.setdefault("device", settings["device"])
        return cls(router=router, backend=backend, sink=sink, engine=engine,
                   **filtered_kwargs(cls, flow_kwargs))

    # ---- built-in fallback path ----

    def _builtin_engine(self):
        if self._engine is None:
            from .torch_backend import load_or_build_packed_index
            from ...engine.query_engine import EngineConfig, TorchQueryEngine

            index = load_or_build_packed_index(self.index_path)
            self._engine = TorchQueryEngine(
                index,
                device=self.device,
                config=EngineConfig(graph_window=self.graph_window),
                sink=self.sink,
            )
        return self._engine

    def _builtin_retrieve(self, req: RetrievalIn) -> RetrievalOut:
        trace_id = req.trace_id or "trace-retrieval"
        queries = [req.query]
        if self._expander is not None:
            queries += self._expander.expand(query=req.query, trace_id=trace_id)

        engine = self._builtin_engine()
        top_k = int(req.top_k or 20)
        result = engine.query_batch(
            [req.query], expansions=[queries[1:]], top_k=top_k,
            graph_window=self.graph_window, trace_id=trace_id,
        )
        hits = engine.hydrate_hits(result, 0)
        return RetrievalOut(
            hits=hits,
            diagnostics={
                "queries": queries,
                "mode": "builtin-engine",
                "alpha_text": self.alpha_text,
                "alpha_graph": self.alpha_graph,
                **result.diagnostics,
            },
        )

    # ---- public ----

    def retrieve(self, req: RetrievalIn) -> RetrievalOut:
        trace_id = getattr(req, "trace_id", None) or "trace-retrieval"
        if self.backend is not None:
            with span("RetrievalAdapter/backend", self.sink, trace_id):
                return self.backend.retrieve(req)
        with span("RetrievalAdapter/flow", self.sink, trace_id):
            return self._builtin_retrieve(req)
