"""The port's copy of ``a_modular_rag_framework_tpu/modules/reasoning/__init__.py``.
"""
from .flow import ReasoningAgentFlow
from .impl_planner_synth import ReasoningAgentPlannerSynth

__all__ = ["ReasoningAgentFlow", "ReasoningAgentPlannerSynth"]
