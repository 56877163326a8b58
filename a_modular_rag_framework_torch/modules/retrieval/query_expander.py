"""LLM query expansion with static attribute-paraphrase fallbacks.

The port's copy of ``a_modular_rag_framework_tpu/modules/retrieval/query_expander.py``.

Capability parity with the reference's LLMQueryExpander
(retrieval_backend.py:18-102): one routed LLM call producing up to ``lines``
short reformulations, deduplicated and merged with rule-based paraphrases of
relation words (nationality/spouse/birthplace/...) that improve recall when
the LLM is mocked or fails.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from ...core.llm_router import LLMRouter

logger = logging.getLogger(__name__)

# relation term -> short paraphrase alternates (first two are used)
ATTRIBUTE_PARAPHRASES: Dict[str, List[str]] = {
    "nationality": ["citizen of", "from", "born in", "is an American", "is a British"],
    "spouse": ["married to", "husband", "wife"],
    "birth place": ["born in", "hails from"],
    "birthplace": ["born in", "native of"],
    "death place": ["died in", "passed away in"],
    "profession": ["worked as", "career as"],
}


def coerce_text(out: Any) -> str:
    """Best-effort extraction of the text payload from provider outputs."""
    if out is None:
        return ""
    if isinstance(out, str):
        return out
    if isinstance(out, dict):
        t = out.get("text")
        if isinstance(t, str):
            return t
        if isinstance(t, dict):
            for key in ("text", "content"):
                if isinstance(t.get(key), str):
                    return t[key]
        msg = out.get("message")
        if isinstance(msg, dict) and isinstance(msg.get("content"), str):
            return msg["content"]
        choices = out.get("choices")
        if isinstance(choices, list) and choices and isinstance(choices[0], dict):
            ch = choices[0]
            if isinstance(ch.get("text"), str):
                return ch["text"]
            m = ch.get("message")
            if isinstance(m, dict) and isinstance(m.get("content"), str):
                return m["content"]
    return ""


class LLMQueryExpander:
    def __init__(self, router: Optional[LLMRouter], lines: int = 3,
                 enable_attribute_paraphrase: bool = True):
        self.router = router
        self.lines = int(lines)
        self.enable_attribute_paraphrase = enable_attribute_paraphrase

    def _prompt(self, query: str) -> str:
        if not self.enable_attribute_paraphrase:
            return f"Expand {self.lines} short queries (one per line) for: {query}"
        return (
            "You are improving recall for a retrieval system.\n"
            f"Task: Expand {self.lines} short search queries (one per line) for:\n"
            f"{query}\n\n"
            "Rules:\n"
            "- Include paraphrases and synonyms.\n"
            "- Expand with related attributes or relations\n"
            "  (e.g. nationality -> born in, citizen of, from).\n"
            "- Keep each line short (<=8 words), no numbering.\n"
        )

    def _static_fallbacks(self, query: str) -> List[str]:
        ql = (query or "").lower()
        extras: List[str] = []
        for key, alts in ATTRIBUTE_PARAPHRASES.items():
            if key in ql:
                extras.extend(alts[:2])
        if extras and len(query.split()) <= 10:
            extras = [f"{alt} {query}" for alt in extras]
        return extras

    def expand(self, *, query: str, trace_id: str) -> List[str]:
        lines: List[str] = []
        if self.router is not None:
            try:
                out = self.router.complete(
                    module="RetrievalAgent",
                    purpose="query_expand",
                    prompt=self._prompt(query),
                    require={"context_window": 8000, "temperature": 0.2,
                             "trace_id": trace_id},
                )
                text = coerce_text(out)
                lines = [ln.lstrip("-•").strip() for ln in (text or "").splitlines()
                         if ln.strip()]
            except Exception as e:
                logger.error("[LLMQueryExpander] expand error: %r", e)

        merged: List[str] = []
        seen = set()
        for q in lines + self._static_fallbacks(query):
            ql = q.lower()
            if ql and ql not in seen:
                seen.add(ql)
                merged.append(q)
        return merged[: self.lines]
