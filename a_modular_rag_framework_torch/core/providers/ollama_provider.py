"""Local Ollama HTTP provider with deterministic offline fallback.

The port's copy of ``a_modular_rag_framework_tpu/core/providers/ollama_provider.py``
(capability parity with the reference implementation's Ollama provider).
``requests`` is imported inside the call: where it is missing, or the
server does not answer, every call falls back to the MockProvider.
"""
from __future__ import annotations

import json
import logging
from typing import Any, Dict, List

from .mock_provider import MockProvider

logger = logging.getLogger(__name__)


class OllamaProvider:
    def __init__(
        self,
        base_url: str = "http://localhost:11434",
        model_default: str = "llama3.1",
        embed_dim_fallback: int = 64,
        timeout: float = 30.0,
        **_: Any,
    ):
        self.base_url = base_url.rstrip("/")
        self.model_default = model_default
        self.timeout = timeout
        self._mock = MockProvider(embed_dim=embed_dim_fallback)

    def complete(self, prompt: str, *, temperature: float = 0.2, max_tokens: int = 512, **kw: Any) -> Dict[str, Any]:
        model = kw.get("model") or self.model_default
        try:
            import requests

            r = requests.post(
                f"{self.base_url}/api/generate",
                json={
                    "model": model,
                    "prompt": prompt,
                    "stream": False,
                    "options": {"temperature": temperature, "num_predict": max_tokens},
                },
                timeout=self.timeout,
            )
            r.raise_for_status()
            data = json.loads(r.text)
            text = data.get("response", "")
            return {"text": text, "tokens": len(text) // 4}
        except Exception as e:
            logger.debug("[OllamaProvider] complete error -> mock: %r", e)
            return self._mock.complete(prompt, **kw)

    def embed(self, texts: List[str], **kw: Any) -> Dict[str, Any]:
        model = kw.get("model") or self.model_default
        try:
            import requests

            vectors: List[List[float]] = []
            for t in texts:
                r = requests.post(
                    f"{self.base_url}/api/embeddings",
                    json={"model": model, "prompt": t},
                    timeout=self.timeout,
                )
                r.raise_for_status()
                vectors.append(r.json().get("embedding", []))
            if vectors and all(vectors):
                return {"vectors": vectors}
        except Exception as e:
            logger.debug("[OllamaProvider] embed error -> mock: %r", e)
        return self._mock.embed(texts, **kw)
