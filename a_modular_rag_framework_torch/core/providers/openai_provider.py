"""OpenAI chat + embeddings provider with deterministic offline fallback.

The port's copy of ``a_modular_rag_framework_tpu/core/providers/openai_provider.py``,
but for the constructor: it looks the SDK up without importing it, so a
settings file that lists this provider loads no SDK (and none of the
pydantic it depends on) until a live call is made.

Capability parity with the reference implementation's app/core/providers/openai_provider.py
(chat completions, embeddings, proxy support, mock fallback when the SDK or
API key is missing) — without its copy-paste bug where ``model_default`` was
read from ``api_key`` (openai_provider.py:19).
"""
from __future__ import annotations

import importlib.util
import logging
import os
from typing import Any, Dict, List, Optional

from .mock_provider import MockProvider

logger = logging.getLogger(__name__)


class OpenAIProvider:
    def __init__(
        self,
        api_key: Optional[str] = None,
        model_default: str = "gpt-4o-mini",
        embed_model: str = "text-embedding-3-large",
        proxy: str = "",
        embed_dim_fallback: int = 64,
        **_: Any,
    ):
        key = api_key or ""
        # Support both "${OPENAI_API_KEY}" (resolved upstream) and the bare
        # env-var-name convention used by the reference config.
        if key and key == key.upper() and key.replace("_", "").isalpha():
            key = os.getenv(key, "")
        self.api_key = key
        self.model_default = model_default
        self.embed_model = embed_model
        self.proxy = proxy
        self._mock = MockProvider(embed_dim=embed_dim_fallback)

        # found, not imported: the SDK (and the pydantic it brings) loads
        # only when a live call is made
        self._has_sdk = importlib.util.find_spec("openai") is not None

    @property
    def live(self) -> bool:
        return self._has_sdk and bool(self.api_key)

    def _client(self):
        from openai import OpenAI

        if self.proxy:
            import httpx

            http_client = httpx.Client(
                transport=httpx.HTTPTransport(proxy=self.proxy), timeout=30.0
            )
            return OpenAI(api_key=self.api_key, http_client=http_client)
        return OpenAI(api_key=self.api_key)

    def complete(self, prompt: str, *, temperature: float = 0.2, max_tokens: int = 512, **kw: Any) -> Dict[str, Any]:
        model = kw.get("model") or self.model_default
        if self.live:
            try:
                resp = self._client().chat.completions.create(
                    model=model,
                    messages=[{"role": "user", "content": prompt}],
                    temperature=temperature,
                    max_tokens=max_tokens,
                )
                text = resp.choices[0].message.content or ""
                usage = getattr(resp, "usage", None)
                tokens = getattr(usage, "total_tokens", 0) if usage else 0
                return {"text": text, "tokens": tokens}
            except Exception as e:
                logger.error("[OpenAIProvider] complete error -> mock: %r", e)
        return self._mock.complete(prompt, **kw)

    def embed(self, texts: List[str], **kw: Any) -> Dict[str, Any]:
        model = kw.get("model") or self.embed_model
        if self.live:
            try:
                resp = self._client().embeddings.create(model=model, input=list(texts))
                return {"vectors": [d.embedding for d in resp.data]}
            except Exception as e:
                logger.error("[OpenAIProvider] embed error -> mock: %r", e)
        return self._mock.embed(texts, **kw)
