"""Retrieval data contracts without pydantic (port of ``Hit`` and
``HitBatch`` in ``a_modular_rag_framework_tpu/core/dto.py``, whose module
is pydantic models): the same fields, as plain dataclasses.

A batch of top-K hits travels as arrays (`HitBatch`) and becomes per-hit
`Hit` objects only at the host boundary (`TorchQueryEngine.hydrate_hits`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np


@dataclass
class Hit:
    id: str
    score: float
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class HitBatch:
    ids: np.ndarray  # [B, K] int32, -1 padded
    scores: np.ndarray  # [B, K] f32
