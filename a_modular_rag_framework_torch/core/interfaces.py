"""Agent protocols (L2) — decouple the orchestrator from implementations.

The port's copy of ``a_modular_rag_framework_tpu/core/interfaces.py``.

Capability parity with the reference implementation's app/core/interfaces.py:10-24.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

from .dto import (
    GraphBuildIn,
    GraphBuildOut,
    ReasoningIn,
    ReasoningOut,
    RetrievalIn,
    RetrievalOut,
    VerifyIn,
    VerifyOut,
)


@runtime_checkable
class GraphConstruction(Protocol):
    """Build an evidence graph (nodes/edges) for one question, persist it,
    and return a `GraphBuildOut` with counts + diagnostics."""

    def build(self, req: GraphBuildIn) -> GraphBuildOut: ...


@runtime_checkable
class RetrievalAgent(Protocol):
    def retrieve(self, req: RetrievalIn) -> RetrievalOut: ...


@runtime_checkable
class ReasoningAgent(Protocol):
    def reason(self, req: ReasoningIn) -> ReasoningOut: ...


@runtime_checkable
class VerifierAgent(Protocol):
    def verify(self, req: VerifyIn) -> VerifyOut: ...
