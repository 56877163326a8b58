"""The port's copy of ``a_modular_rag_framework_tpu/orchestrator/__init__.py``.
"""
from .nodes import NodeContext
from .state import WFState
from .workflow import build_workflow

__all__ = ["NodeContext", "WFState", "build_workflow"]
