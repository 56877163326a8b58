"""Policy-based LLM router (L1) with telemetry and mock fallback.

The port's copy of ``a_modular_rag_framework_tpu/core/llm_router.py``.

Semantics parity with the reference implementation's app/core/llm_router.py:13-146:
  - ``select(module, purpose)`` resolves llm_policy.routes.<module>.<purpose>,
    falling back to llm_policy.default, then to a mock decision;
  - ``complete`` / ``embed`` wrap provider calls with error->mock degradation
    and per-call telemetry (provider/model/tokens/latency).

Addition: ``embedding_provider`` may name a `TorchEmbedProvider`, putting
the embedding path on the local accelerator instead of a remote API.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

from ..telemetry.sinks import TelemetrySink, record_llm_call
from .providers.mock_provider import MockProvider

logger = logging.getLogger(__name__)


class LLMRouteDecision(dict):
    @property
    def model(self):
        return self.get("model")

    @property
    def provider(self):
        return self.get("provider")

    @property
    def reason(self):
        return self.get("reason")


class LLMRouter:
    def __init__(
        self,
        providers: Dict[str, Any],
        policy: Dict[str, Any],
        sink: Optional[TelemetrySink] = None,
    ):
        self.providers = providers or {}
        self.policy = policy or {}
        self.sink = sink
        self._mock = MockProvider()

    # ---- routing ----

    def select(self, module: str, purpose: str, require: Optional[Dict[str, Any]] = None) -> LLMRouteDecision:
        routes = ((self.policy or {}).get("routes") or {}).get(module, {}) or {}
        cands: List[Dict[str, Any]] = list(routes.get(purpose) or [])
        if not cands:
            cands = list((self.policy or {}).get("default") or [])
        if not cands:
            return LLMRouteDecision(model="mock", provider="mock", reason="no_policy")
        return LLMRouteDecision(**cands[0], reason=f"policy:{module}/{purpose}")

    # ---- completion ----

    def complete(
        self,
        *,
        module: str,
        purpose: str,
        prompt: str,
        require: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        req = dict(require or {})
        dec = self.select(module, purpose, req)
        provider_name, model_name = dec.provider, dec.model
        provider = self.providers.get(provider_name)

        t0 = time.time()
        text, err, fb_reason = "", None, None
        call_kw = {
            "model": model_name,
            "temperature": req.get("temperature", 0.2),
            "max_tokens": req.get("max_tokens", 512),
            "module": module,
            "purpose": purpose,
        }
        try:
            if provider is not None and provider_name != "mock":
                out = provider.complete(prompt, **call_kw)
                text = out.get("text", "") if isinstance(out, dict) else str(out or "")
            else:
                fb_reason = "no_policy" if provider_name == "mock" else "no_provider"
                text = self._mock.complete(prompt, **call_kw)["text"]
        except Exception as e:
            err, fb_reason = repr(e), "error"
            logger.error("[LLMRouter] complete error -> mock: %r", e)
            text = self._mock.complete(prompt, **call_kw)["text"]
        latency_ms = (time.time() - t0) * 1000.0

        trace_id = req.get("trace_id") or ""
        if self.sink and trace_id:
            record_llm_call(
                self.sink,
                trace_id,
                {
                    "provider": provider_name or "mock",
                    "model": model_name or "mock",
                    "tokens_in": len(prompt) // 4,
                    "tokens_out": len(text) // 4,
                    "latency_ms": latency_ms,
                    "cached": False,
                    "temperature": req.get("temperature"),
                    "max_tokens": req.get("max_tokens"),
                    "module": module,
                    "purpose": purpose,
                    "error": err,
                },
            )

        return {
            "text": text,
            "_provider": provider_name,
            "_model": model_name,
            "_route_reason": dec.reason,
            "_latency_ms": latency_ms,
            "_error": err,
            "_fallback_reason": fb_reason,
        }

    # ---- embeddings ----

    def embed(
        self,
        *,
        model_hint: str = "",
        texts: List[str],
        require: Optional[Dict[str, Any]] = None,
    ) -> List[List[float]]:
        req = dict(require or {})
        provider_name = (self.policy or {}).get("embedding_provider") or "mock"
        provider = self.providers.get(provider_name)

        t0 = time.time()
        err = None
        try:
            if provider is not None and provider_name != "mock":
                out = provider.embed(list(texts), model=model_hint)
                vecs = out.get("vectors") if isinstance(out, dict) else out
                vecs = [list(map(float, v)) for v in (vecs or [])]
            else:
                vecs = self._mock.embed(list(texts))["vectors"]
        except Exception as e:
            err = repr(e)
            logger.error("[LLMRouter] embed error -> mock: %r", e)
            vecs = self._mock.embed(list(texts))["vectors"]
        latency_ms = (time.time() - t0) * 1000.0

        trace_id = req.get("trace_id") or ""
        if self.sink and trace_id:
            record_llm_call(
                self.sink,
                trace_id,
                {
                    "provider": provider_name or "mock",
                    "model": model_hint or "mock",
                    "tokens_in": 0,
                    "tokens_out": 0,
                    "latency_ms": latency_ms,
                    "cached": False,
                    "module": "Embedding",
                    "purpose": "embed",
                    "error": err,
                },
            )
        return vecs

    def resolve_embed_model(self) -> str:
        emb = (self.policy or {}).get("embedding") or []
        if emb and isinstance(emb[0], dict) and emb[0].get("model"):
            return str(emb[0]["model"])
        return "torch-hash-encoder"
