"""Host state machine (L4) — hand-rolled, no langgraph dependency.

The port's copy of ``a_modular_rag_framework_tpu/orchestrator/workflow.py``.

Topology parity with the reference implementation's app/orchestrator/workflow.py:100-154:

  START -> InitExternal -> Ingest -> BuildGraph -> ChooseRoute
    -(route)-> Retrieval -> Reasoning -> Verify
       -(verify_selector)-> RetryRetrieval -> Reasoning -> Verify (max 1)
       -(else)-> PackResult -> END
    -(else)-> PackResult -> END

Implemented as an explicit transition table over named nodes; the compiled
workflow exposes ``invoke(state) -> state`` like LangGraph's CompiledGraph.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .nodes import (
    NodeContext,
    make_node_build_graph,
    make_node_choose_route,
    make_node_claim_retrieval,
    make_node_ingest,
    make_node_init_external,
    make_node_pack_result,
    make_node_reasoning,
    make_node_retrieval,
    make_node_verify,
    should_retry,
)
from .state import WFState

START = "__start__"
END = "__end__"


class StateMachine:
    """Minimal sequential state machine with conditional transitions."""

    def __init__(self, max_steps: int = 64):
        self.nodes: Dict[str, Callable[[WFState], WFState]] = {}
        self.edges: Dict[str, Any] = {}
        self.max_steps = max_steps

    def add_node(self, name: str, fn: Callable[[WFState], WFState]) -> None:
        self.nodes[name] = fn

    def add_edge(self, src: str, dst: str) -> None:
        self.edges[src] = dst

    def add_conditional_edges(self, src: str, selector: Callable[[WFState], str],
                              mapping: Dict[str, str]) -> None:
        self.edges[src] = (selector, mapping)

    def invoke(self, input: WFState) -> WFState:  # noqa: A002 - LangGraph-compatible name
        state = dict(input)
        current = self.edges.get(START)
        steps = 0
        while current != END and current is not None:
            steps += 1
            if steps > self.max_steps:
                raise RuntimeError(f"workflow exceeded {self.max_steps} steps")
            fn = self.nodes.get(current)
            if fn is None:
                raise KeyError(f"unknown workflow node {current!r}")
            state = fn(state)  # type: ignore[assignment]
            edge = self.edges.get(current)
            if isinstance(edge, tuple):
                selector, mapping = edge
                current = mapping[selector(state)]
            else:
                current = edge
        return state  # type: ignore[return-value]


def route_selector(state: WFState) -> str:
    return "Retrieval" if state.get("route") == "Retrieval" else "PackResult"


def verify_selector(state: WFState) -> str:
    # node_verify sets _want_retry via should_retry (verdict in the retry
    # set, or low-confidence pass, and retries < MAX_RETRIES)
    if state.get("_want_retry"):
        return "RetryRetrieval"
    return "PackResult"


def build_workflow(
    ctx: NodeContext,
    dataset_cfg: Optional[Dict[str, Any]] = None,
    dataset_loader: Any = None,
) -> StateMachine:
    g = StateMachine()

    g.add_node("InitExternal", make_node_init_external(ctx, dataset_loader))
    g.add_node("Ingest", make_node_ingest(ctx))
    g.add_node("BuildGraph", make_node_build_graph(ctx))
    g.add_node("ChooseRoute", make_node_choose_route(ctx))
    g.add_node("Retrieval", make_node_retrieval(ctx))
    g.add_node("Reasoning", make_node_reasoning(ctx))
    g.add_node("Verify", make_node_verify(ctx))
    g.add_node("PackResult", make_node_pack_result(ctx))

    g.add_node("RetryRetrieval", make_node_claim_retrieval(ctx))

    g.add_edge(START, "InitExternal")
    g.add_edge("InitExternal", "Ingest")
    g.add_edge("Ingest", "BuildGraph")
    g.add_edge("BuildGraph", "ChooseRoute")
    g.add_conditional_edges("ChooseRoute", route_selector,
                            {"Retrieval": "Retrieval", "PackResult": "PackResult"})
    g.add_edge("Retrieval", "Reasoning")
    g.add_edge("Reasoning", "Verify")
    g.add_conditional_edges("Verify", verify_selector,
                            {"RetryRetrieval": "RetryRetrieval",
                             "PackResult": "PackResult"})
    g.add_edge("RetryRetrieval", "Reasoning")
    g.add_edge("PackResult", END)
    return g
