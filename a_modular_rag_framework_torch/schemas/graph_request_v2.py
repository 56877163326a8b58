"""v2 graph-assembly request schema, without pydantic.

Port of ``a_modular_rag_framework_tpu/schemas/graph_request_v2.py`` (the
richer request shape accepted by the v1 -> v2 adapter,
`adapters.graph_request_adapter`), over the port's `core.dto.Model`: the
same classes, fields and defaults; ``Field(default_factory=...)`` becomes
``_factory(...)``.
"""
from __future__ import annotations

from typing import Any, Dict, List

from ..core.dto import Model, _factory


class Sentence(Model):
    id: str
    text: str
    meta: Dict[str, Any] = _factory(dict)


class Inputs(Model):
    sentences: List[Sentence] = _factory(list)
    nodes: List[Dict[str, Any]] = _factory(list)
    edges: List[Dict[str, Any]] = _factory(list)


class AssembleGraphRequestV2(Model):
    api_version: str = "v2"
    graph_id: str
    inputs: Inputs = _factory(Inputs)
    options: Dict[str, Any] = _factory(dict)
