"""Reasoning flow adapter (L3): instantiates the impl from settings with
reflection-filtered kwargs (parity with reasoning/flow.py:12-73).

The port's copy of ``a_modular_rag_framework_tpu/modules/reasoning/flow.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ...core.dto import ReasoningIn, ReasoningOut
from ...core.llm_router import LLMRouter
from ...di.factory import filtered_kwargs, import_from_string
from ...telemetry.sinks import TelemetrySink, span

DEFAULT_IMPL = (
    "a_modular_rag_framework_torch.modules.reasoning.impl_planner_synth:ReasoningAgentPlannerSynth"
)


class ReasoningAgentFlow:
    def __init__(self, impl: Any, sink: Optional[TelemetrySink] = None):
        self.impl = impl
        self.sink = sink

    @classmethod
    def from_settings(
        cls,
        settings: Dict[str, Any],
        router: Optional[LLMRouter] = None,
        sink: Optional[TelemetrySink] = None,
    ) -> "ReasoningAgentFlow":
        cfg = (settings.get("modules", {}) or {}).get("reasoning", {}) or {}
        impl_spec = cfg.get("impl") or DEFAULT_IMPL
        impl_cls = import_from_string(impl_spec)
        impl_kwargs = filtered_kwargs(
            impl_cls, dict(cfg.get("impl_kwargs") or {}),
            inject={"router": router, "sink": sink},
        )
        return cls(impl=impl_cls(**impl_kwargs), sink=sink)

    def reason(self, req: ReasoningIn) -> ReasoningOut:
        trace_id = req.trace_id or "trace-reason"
        with span("ReasoningFlow", self.sink, trace_id):
            return self.impl.reason(req)
