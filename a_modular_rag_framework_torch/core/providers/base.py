"""Provider protocol (L0).

The port's copy of ``a_modular_rag_framework_tpu/core/providers/base.py``.

Parity with the reference implementation's app/core/providers/base.py:4-6. Every provider
must degrade to a deterministic offline result on any failure so the whole
pipeline runs end-to-end with zero credentials/network.
"""
from __future__ import annotations

from typing import Any, Dict, List, Protocol, runtime_checkable


@runtime_checkable
class LLMProvider(Protocol):
    def complete(self, prompt: str, **kw: Any) -> Dict[str, Any]:
        """Return ``{"text": str, "tokens": int}``."""
        ...

    def embed(self, texts: List[str], **kw: Any) -> Dict[str, Any]:
        """Return ``{"vectors": List[List[float]]}``."""
        ...
