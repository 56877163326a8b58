"""Verification flow adapter (L3): reflection-filtered impl instantiation
(parity with verification/flow.py:11-74).

The port's copy of ``a_modular_rag_framework_tpu/modules/verification/flow.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ...core.dto import VerifyIn, VerifyOut
from ...core.llm_router import LLMRouter
from ...di.factory import filtered_kwargs, import_from_string
from ...telemetry.sinks import TelemetrySink, span

DEFAULT_IMPL = (
    "a_modular_rag_framework_torch.modules.verification.impl_rules_llm:VerifierAgentRulesLLM"
)


class VerifierAgentFlow:
    def __init__(self, impl: Any, sink: Optional[TelemetrySink] = None):
        self.impl = impl
        self.sink = sink

    @classmethod
    def from_settings(
        cls,
        settings: Dict[str, Any],
        router: Optional[LLMRouter] = None,
        sink: Optional[TelemetrySink] = None,
        claim_retriever: Any = None,
    ) -> "VerifierAgentFlow":
        cfg = (settings.get("modules", {}) or {}).get("verification", {}) or {}
        impl_spec = cfg.get("impl") or DEFAULT_IMPL
        impl_cls = import_from_string(impl_spec)
        impl_kwargs = filtered_kwargs(
            impl_cls, dict(cfg.get("impl_kwargs") or {}),
            inject={"router": router, "sink": sink,
                    "external_claim_retriever": claim_retriever},
        )
        return cls(impl=impl_cls(**impl_kwargs), sink=sink)

    def verify(self, req: VerifyIn) -> VerifyOut:
        trace_id = req.trace_id or "trace-verify"
        with span("VerifierFlow", self.sink, trace_id):
            return self.impl.verify(req)
