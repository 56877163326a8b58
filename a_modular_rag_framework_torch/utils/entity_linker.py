"""Entity linking with a fallback chain (host-side).

The port's copy of ``a_modular_rag_framework_tpu/utils/entity_linker.py``.
Capability parity with the reference implementation's
app/utils/entity_linker.py:12-94:
callback provider -> HTTP ``ELQ_ENDPOINT`` -> regex NER -> deterministic
mock. The linked entities feed entity nodes (graph construction) and the
entity-link adjacency used for multi-hop frontier expansion on device.
"""
from __future__ import annotations

import logging
import os
import re
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

from .textspan import capitalized_runs


def simple_ner(text: str) -> List[str]:
    """Lightweight proper-noun span extraction."""
    return capitalized_runs(text or "")


def _mock_entities(text: str, max_entities: int) -> List[Dict[str, str]]:
    """Deterministic fallback: link the proper-noun spans found in the text
    itself (unlike the reference's two fixed entities, this keeps offline
    graphs meaningful)."""
    seen: List[str] = []
    for m in simple_ner(text):
        if m not in seen:
            seen.append(m)
    out = []
    for i, t in enumerate(seen[:max_entities]):
        out.append(
            {
                "id": f"E{i + 1}",
                "text": t,
                "mention": t,
                "canonical": t,
                "score": 0.9,
                "source": "regex-ner",
            }
        )
    return out


def elq_link_entities(
    text: str,
    *,
    use_real_elq: bool = False,
    max_entities: int = 8,
    provider: Optional[Callable[[List[str]], List[Dict[str, str]]]] = None,
) -> List[Dict[str, str]]:
    """Unified entity-linking entry; every record has at least id + text."""
    if not text:
        return []

    if not use_real_elq:
        return _mock_entities(text, max_entities)

    mentions = simple_ner(text)[:max_entities]

    if provider is not None:
        try:
            out = provider(mentions) or []
            fixed = []
            for e in out[:max_entities]:
                eid = e.get("id") or e.get("qid") or f"ELQ::{e.get('canonical') or e.get('mention') or 'unknown'}"
                t = e.get("text") or e.get("canonical") or e.get("mention") or eid
                fixed.append({"id": eid, "text": t, **{k: v for k, v in e.items() if k not in {"id", "text"}}})
            if fixed:
                return fixed
        except Exception as e:
            logger.debug("entity provider failed: %r", e)

    endpoint = os.environ.get("ELQ_ENDPOINT")
    if endpoint:
        try:
            import requests

            resp = requests.post(endpoint, json={"mentions": mentions, "text": text}, timeout=10)
            resp.raise_for_status()
            arr = resp.json() or []
            fixed = []
            for e in arr[:max_entities]:
                eid = e.get("id") or e.get("qid") or f"ELQ::{e.get('canonical') or e.get('mention') or 'unknown'}"
                t = e.get("text") or e.get("canonical") or e.get("mention") or eid
                fixed.append({"id": eid, "text": t, **{k: v for k, v in e.items() if k not in {"id", "text"}}})
            if fixed:
                return fixed
        except Exception as e:
            logger.debug("ELQ endpoint failed: %r", e)

    return _mock_entities(text, max_entities)
