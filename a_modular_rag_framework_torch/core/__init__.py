from .dto import (
    EdgeEvidence,
    GraphBuildIn,
    GraphBuildOut,
    GraphEdge,
    GraphNode,
    Hit,
    HitBatch,
    ReasoningIn,
    ReasoningOut,
    RetrievalIn,
    RetrievalOut,
    VerifyIn,
    VerifyOut,
)
from .interfaces import GraphConstruction, ReasoningAgent, RetrievalAgent, VerifierAgent
from .llm_router import LLMRouteDecision, LLMRouter

__all__ = [
    "EdgeEvidence",
    "GraphBuildIn",
    "GraphBuildOut",
    "GraphConstruction",
    "GraphEdge",
    "GraphNode",
    "Hit",
    "HitBatch",
    "LLMRouteDecision",
    "LLMRouter",
    "ReasoningAgent",
    "ReasoningIn",
    "ReasoningOut",
    "RetrievalAgent",
    "RetrievalIn",
    "RetrievalOut",
    "VerifierAgent",
    "VerifyIn",
    "VerifyOut",
]
