"""Orchestrator nodes (L4).

The port's copy of ``a_modular_rag_framework_tpu/orchestrator/nodes.py``.

Node-set parity with the reference implementation's app/orchestrator/nodes.py:15-272:
InitExternal / Ingest / BuildGraph / ChooseRoute / Retrieval / Reasoning /
Verify / PackResult / RetryRetrieval (claim-based fallback retrieval). Each
node is a pure ``WFState -> WFState`` function wrapped in a telemetry span;
the retry decision lives in `workflow.verify_selector`.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from ..core.dto import GraphBuildIn, ReasoningIn, RetrievalIn, RetrievalOut, VerifyIn
from ..core.interfaces import (
    GraphConstruction,
    ReasoningAgent,
    RetrievalAgent,
    VerifierAgent,
)
from ..telemetry.sinks import TelemetrySink, span
from .state import WFState

RETRY_VERDICTS = ("FAIL-UNSUPPORTED", "FAIL-CONTRADICTED", "INCONCLUSIVE")
LOW_CONF_RETRY_SCORE = 0.55
MAX_RETRIES = 1


class NodeContext:
    def __init__(
        self,
        graph_c: GraphConstruction,
        retriever: RetrievalAgent,
        reasoner: ReasoningAgent,
        verifier: VerifierAgent,
        sink: Optional[TelemetrySink] = None,
    ):
        self.graph_c = graph_c
        self.retriever = retriever
        self.reasoner = reasoner
        self.verifier = verifier
        self.sink = sink


def _merge(state: WFState, extra: Dict[str, Any]) -> WFState:
    new_state = dict(state)
    new_state.update(extra)
    return new_state  # type: ignore[return-value]


def make_node_init_external(ctx: NodeContext, dataset_loader=None) -> Callable[[WFState], WFState]:
    """Match the question against the dataset to attach context + gold meta
    (falls back to the first sample, as the reference does)."""

    def node(state: WFState) -> WFState:
        trace_id = state.get("trace_id", "trace-demo")
        with span("InitExternal", ctx.sink, trace_id):
            if dataset_loader is None:
                return state
            try:
                samples = dataset_loader.load()
            except FileNotFoundError:
                return state
            q = (state.get("question") or "").strip()
            matched = next(
                (s for s in samples if (s.get("question") or "").strip() == q), None
            )
            if matched is None and samples:
                matched = samples[0]
            if matched is None:
                return state
            return _merge(state, {
                "external_context": {"context": matched.get("context", [])},
                "meta": {
                    "_id": matched.get("_id"),
                    "answer": matched.get("answer"),
                    "supporting_facts": matched.get("supporting_facts", []),
                    "type": matched.get("type"),
                    "level": matched.get("level"),
                },
            })

    return node


def make_node_ingest(ctx: NodeContext) -> Callable[[WFState], WFState]:
    def node(state: WFState) -> WFState:
        trace_id = state.get("trace_id", "trace-demo")
        with span("Ingest", ctx.sink, trace_id):
            q = (state.get("question") or "").strip()
            if not q:
                raise ValueError("Empty question")
            ext = dict(state.get("external_context") or {})
            if not isinstance(ext.get("context"), list):
                ext["context"] = []
            return _merge(state, {"question": q, "external_context": ext})

    return node


def make_node_build_graph(ctx: NodeContext) -> Callable[[WFState], WFState]:
    def node(state: WFState) -> WFState:
        trace_id = state.get("trace_id", "trace-demo")
        with span("BuildGraph", ctx.sink, trace_id):
            t0 = time.time()
            out = ctx.graph_c.build(GraphBuildIn(
                trace_id=trace_id,
                question_text=state["question"],
                context=(state.get("external_context") or {}).get("context", []),
                extra={"meta": state.get("meta", {})},
            ))
            t1 = time.time()
            return _merge(state, {"graph": out.model_dump(),
                                  "t0": state.get("t0", t0), "t1": t1})

    return node


def make_node_choose_route(ctx: NodeContext) -> Callable[[WFState], WFState]:
    def node(state: WFState) -> WFState:
        trace_id = state.get("trace_id", "trace-demo")
        with span("ChooseRoute", ctx.sink, trace_id):
            raw_mode = (state.get("policy") or {}).get("mode", "graph_only")
            mode = raw_mode.strip().lower() if isinstance(raw_mode, str) else "graph_only"
            return _merge(state, {"route": "Retrieval" if mode == "full" else "PackResult"})

    return node


def make_node_retrieval(ctx: NodeContext) -> Callable[[WFState], WFState]:
    def node(state: WFState) -> WFState:
        if state.get("route") != "Retrieval":
            return state
        trace_id = state.get("trace_id", "trace-demo")
        with span("Retrieval", ctx.sink, trace_id):
            r = ctx.retriever.retrieve(RetrievalIn(
                query=state.get("question", ""),
                graph_id=(state.get("graph") or {}).get("graph_id", ""),
                top_k=20,
                trace_id=trace_id,
            ))
            return _merge(state, {"retrieval": r.model_dump()})

    return node


def make_node_reasoning(ctx: NodeContext) -> Callable[[WFState], WFState]:
    def node(state: WFState) -> WFState:
        if state.get("route") != "Retrieval":
            return state
        trace_id = state.get("trace_id", "trace-demo")
        with span("Reasoning", ctx.sink, trace_id):
            r = ctx.reasoner.reason(ReasoningIn(
                question=state.get("question", ""),
                hits=(state.get("retrieval") or {}).get("hits", []),
                graph_id=(state.get("graph") or {}).get("graph_id", ""),
                trace_id=trace_id,
            ))
            return _merge(state, {"reasoning": r.model_dump()})

    return node


def should_retry(verification: Dict[str, Any], retries: int) -> bool:
    verdict = verification.get("verdict")
    status_detail = (verification.get("status_detail") or "").lower()
    final_score = float(verification.get("final_score") or 0.0)
    return (
        verdict in RETRY_VERDICTS
        or (status_detail == "low_conf_pass" and final_score < LOW_CONF_RETRY_SCORE)
    ) and retries < MAX_RETRIES


def make_node_verify(ctx: NodeContext) -> Callable[[WFState], WFState]:
    def node(state: WFState) -> WFState:
        if state.get("route") != "Retrieval":
            return state
        trace_id = state.get("trace_id", "trace-demo")
        retry_round = int(state.get("_verify_retries", 0))
        with span("Verify", ctx.sink, trace_id):
            v = ctx.verifier.verify(VerifyIn(
                answer=(state.get("reasoning") or {}).get("answer", ""),
                evidence=(state.get("retrieval") or {}).get("hits", []),
                graph_id=(state.get("graph") or {}).get("graph_id", ""),
                trace_id=trace_id,
                retry_round=retry_round,
                question=state.get("question"),
                query=state.get("question"),
            ))
        v_dict = v.model_dump()
        want_retry = should_retry(v_dict, retry_round)
        if want_retry:
            retry_round += 1
        v_dict["retry_round"] = retry_round
        return _merge(state, {
            "verification": v_dict,
            "_verify_retries": retry_round,
            "_want_retry": want_retry,
            "retry_round": retry_round,
            "retrieval_source": (state.get("retrieval") or {}).get("source", "default"),
        })

    return node


def make_node_claim_retrieval(ctx: NodeContext) -> Callable[[WFState], WFState]:
    """Fallback retrieval driven by the verifier's claim-check output: claims
    are joined into a new query; hits are tagged source=claim-retrieval."""

    def node(state: WFState) -> WFState:
        trace_id = state.get("trace_id", "trace-claim")
        verification = state.get("verification") or {}
        claims = [
            c["claim"]
            for c in ((verification.get("diagnostics") or {})
                      .get("claim_check", {}).get("results", []))
            if c.get("claim")
        ]
        if not claims:
            empty = RetrievalOut(hits=[], model="claim-fallback").model_dump()
            empty["source"] = "claim-retrieval"
            return _merge(state, {"retrieval": empty})

        # the question stays in the query: claims extracted from a WRONG
        # answer would otherwise steer the re-retrieval to the wrong
        # answer's neighborhood, making recovery impossible — the point
        # of the retry is to re-ground the question, with the claims as
        # additional probes
        question = state.get("question", "")
        with span("ClaimRetrieval", ctx.sink, trace_id):
            out = ctx.retriever.retrieve(RetrievalIn(
                query="; ".join(([question] if question else []) + claims),
                graph_id=(state.get("graph") or {}).get("graph_id", ""),
                top_k=20,
                trace_id=f"{trace_id}-claim",
            ))
        out_dict = out.model_dump()
        for h in out_dict.get("hits", []):
            if isinstance(h, dict):
                h.setdefault("meta", {})["source"] = "claim-retrieval"
        out_dict["source"] = "claim-retrieval"
        return _merge(state, {"retrieval": out_dict})

    return node


def make_node_pack_result(ctx: NodeContext) -> Callable[[WFState], WFState]:
    def node(state: WFState) -> WFState:
        trace_id = state.get("trace_id", "trace-demo")
        retry_round = int(state.get("_verify_retries", 0))
        retrieval = state.get("retrieval") or {}
        retrieval_source = retrieval.get("source", "default")
        with span("PackResult", ctx.sink, trace_id):
            result = {
                "graph": state.get("graph"),
                "retrieval": retrieval,
                "reasoning": state.get("reasoning"),
                "verification": state.get("verification"),
                "metrics": {
                    "t0": state.get("t0"),
                    "t1": state.get("t1"),
                    "t_end": time.time(),
                    "retry_round": retry_round,
                    "retrieval_source": retrieval_source,
                },
                "retry_round": retry_round,
                "retrieval_source": retrieval_source,
            }
            return _merge(state, {"result": result})

    return node
