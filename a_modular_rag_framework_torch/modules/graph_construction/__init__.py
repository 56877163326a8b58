"""The port's copy of ``a_modular_rag_framework_tpu/modules/graph_construction/__init__.py``.
"""
from .flow import GraphConstructionFlow
from .impl_arrays import GraphConstructionArrays
from .node_builder import NodeBuilder
from .edge_builder import EdgeBuilder
from .segmenter import segment_context, simple_rule_split

__all__ = [
    "EdgeBuilder",
    "GraphConstructionArrays",
    "GraphConstructionFlow",
    "NodeBuilder",
    "segment_context",
    "simple_rule_split",
]
