"""Graph-construction flow: the inner per-question pipeline.

The port's copy of ``a_modular_rag_framework_tpu/modules/graph_construction/flow.py``.

Topology parity with the reference implementation's app/modules/graph_construction/
flow.py:32-277 — Ingest -> BootstrapContext (retrieve when context empty) ->
BuildNodes -> BuildEdges -> AssembleSave -> Summarize — implemented as a
plain host pipeline (each stage span-traced) rather than a nested LangGraph:
the stages are strictly sequential, so a state machine adds nothing here.
"""
from __future__ import annotations

import time
import uuid
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from ...core.dto import GraphBuildIn, GraphBuildOut, RetrievalIn
from ...core.llm_router import LLMRouter
from ...di.factory import filtered_kwargs, import_from_string
from ...telemetry.sinks import TelemetrySink, span
from .edge_builder import EdgeBuilder
from .node_builder import NodeBuilder

DEFAULT_IMPL = (
    "a_modular_rag_framework_torch.modules.graph_construction.impl_arrays:GraphConstructionArrays"
)


class GraphConstructionFlow:
    def __init__(
        self,
        impl: Any,
        router: Optional[LLMRouter] = None,
        *,
        node_builder_kwargs: Optional[Dict[str, Any]] = None,
        edge_builder_kwargs: Optional[Dict[str, Any]] = None,
        sink: Optional[TelemetrySink] = None,
        settings: Optional[Dict[str, Any]] = None,
        bootstrap_top_k: int = 20,
        retriever: Any = None,
    ):
        self.impl = impl
        self.router = router
        self.sink = sink
        self.settings = settings or {}
        self.bootstrap_top_k = int(bootstrap_top_k)
        self.retriever = retriever
        self.node_builder = NodeBuilder(**(node_builder_kwargs or {}))
        self.edge_builder = EdgeBuilder(**(edge_builder_kwargs or {}))

    @classmethod
    def from_settings(
        cls,
        settings: Dict[str, Any],
        router: Optional[LLMRouter] = None,
        sink: Optional[TelemetrySink] = None,
        engine: Any = None,
    ) -> "GraphConstructionFlow":
        modules_cfg = settings.get("modules", {}) or {}
        cfg = dict(modules_cfg.get("graph_construction")
                   or settings.get("graph_construction") or {})

        impl_spec = cfg.get("impl") or DEFAULT_IMPL
        impl_kwargs = dict(cfg.get("impl_kwargs") or {})
        node_builder_kwargs = impl_kwargs.pop("node_builder",
                                              cfg.get("node_builder") or {})
        edge_builder_kwargs = impl_kwargs.pop("edge_builder",
                                              cfg.get("edge_builder") or {})

        impl_cls = import_from_string(impl_spec)
        impl = impl_cls(**filtered_kwargs(impl_cls, impl_kwargs))

        bootstrap_top_k = int((cfg.get("bootstrap") or {}).get("top_k", 20))

        retriever = None
        try:
            from ..retrieval.flow import RetrievalAgentFlow

            retriever = RetrievalAgentFlow.from_settings(settings, router=router,
                                                         engine=engine)
        except Exception:
            retriever = None

        return cls(
            impl=impl,
            router=router,
            sink=sink,
            node_builder_kwargs=node_builder_kwargs,
            edge_builder_kwargs=edge_builder_kwargs,
            settings=settings,
            bootstrap_top_k=bootstrap_top_k,
            retriever=retriever,
        )

    # ---- stages ----

    def _bootstrap_context(self, question: str, trace_id: str) -> List[Tuple[str, List[str]]]:
        """When no context is supplied, retrieve one: top-k hits regrouped
        doc -> sentences sorted by sent_id, deduplicated."""
        if self.retriever is None:
            return []
        ro = self.retriever.retrieve(
            RetrievalIn(query=question, graph_id="", top_k=self.bootstrap_top_k,
                        trace_id=trace_id)
        )
        by_doc: Dict[str, List[Tuple[int, str]]] = defaultdict(list)
        for h in ro.hits:
            meta = h.meta or {}
            text = str(meta.get("text") or "")
            if not text:
                continue
            doc = str(meta.get("doc") or "default")
            try:
                sid = int(meta.get("sent_id")) if meta.get("sent_id") is not None else 10**9
            except (TypeError, ValueError):
                sid = 10**9
            by_doc[doc].append((sid, text))

        context: List[Tuple[str, List[str]]] = []
        for doc, pairs in by_doc.items():
            seen = set()
            sents = []
            for _, t in sorted(pairs, key=lambda x: x[0]):
                if t not in seen:
                    seen.add(t)
                    sents.append(t)
            if sents:
                context.append((doc, sents))
        return context

    def build(self, req: GraphBuildIn) -> GraphBuildOut:
        trace_id = req.trace_id or "trace-gc"
        graph_id = req.graph_id or f"graph-{trace_id}-{uuid.uuid4().hex[:8]}"
        policy = (req.extra or {}).get("policy", {}) if isinstance(req.extra, dict) else {}
        context = list(req.context or [])

        if not context:
            with span("GC/BootstrapContext", self.sink, trace_id):
                context = self._bootstrap_context(req.question_text, trace_id)

        with span("GC/BuildNodes", self.sink, trace_id):
            nodes = self.node_builder.build(req.question_text, context, policy)
            node_dicts = [n.model_dump() for n in nodes]
            if req.nodes:
                have = {n["id"] for n in node_dicts}
                node_dicts += [n for n in req.nodes if n.get("id") not in have]

        with span("GC/BuildEdges", self.sink, trace_id):
            edge_dicts = self.edge_builder.build(node_dicts, req.question_text, policy)
            if req.edges:
                edge_dicts = edge_dicts + list(req.edges)

        with span("GC/AssembleSave", self.sink, trace_id):
            t0 = time.time()
            extra = dict(req.extra or {})
            extra["node_builder_diagnostics"] = self.node_builder.last_diagnostics
            extra["edge_builder_diagnostics"] = self.edge_builder.last_diagnostics
            out = self.impl.build(GraphBuildIn(
                trace_id=req.trace_id,
                question_text=req.question_text,
                context=context,
                graph_id=graph_id,
                nodes=node_dicts,
                edges=edge_dicts,
                extra=extra,
            ))
            t1 = time.time()

        return GraphBuildOut(
            graph_id=out.graph_id,
            node_count=out.node_count,
            edge_count=out.edge_count,
            nodes=node_dicts,
            edges=edge_dicts,
            provenance=out.provenance,
            diagnostics={**(out.diagnostics or {}), "t_build_sec": t1 - t0},
            extra=out.extra,
        )
