"""Workflow state (parity with the reference implementation's app/orchestrator/state.py).

The port's copy of ``a_modular_rag_framework_tpu/orchestrator/state.py``.

A plain TypedDict merged by the host state machine between nodes; ``route``
must be declared so conditional transitions can read it.
"""
from __future__ import annotations

from typing import Any, Dict, TypedDict


class WFState(TypedDict, total=False):
    external_context: Dict[str, Any]
    question: str
    trace_id: str
    policy: Dict[str, Any]  # e.g. {"mode": "full"}
    meta: Dict[str, Any]  # gold labels: _id / answer / supporting_facts / ...

    route: str  # "Retrieval" | "PackResult"

    graph: Dict[str, Any]
    retrieval: Dict[str, Any]
    reasoning: Dict[str, Any]
    verification: Dict[str, Any]

    t0: float
    t1: float
    retry_round: int
    retrieval_source: str
    result: Dict[str, Any]
