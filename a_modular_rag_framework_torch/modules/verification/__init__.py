"""The port's copy of ``a_modular_rag_framework_tpu/modules/verification/__init__.py``.
"""
from .flow import VerifierAgentFlow
from .impl_rules_llm import StatusDetail, VerifierAgentRulesLLM

__all__ = ["StatusDetail", "VerifierAgentFlow", "VerifierAgentRulesLLM"]
