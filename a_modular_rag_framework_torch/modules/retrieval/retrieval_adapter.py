"""Compatibility adapter normalizing arbitrary backend hit shapes.

The port's copy of ``a_modular_rag_framework_tpu/modules/retrieval/retrieval_adapter.py``:
wraps any backend whose hits use nonstandard id / score key names and
coerces them into the canonical `Hit{id, score, meta}` contract via
configurable key preference lists.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ...core.dto import Hit, RetrievalIn, RetrievalOut
from ...telemetry.sinks import TelemetrySink, span


class RetrievalAdapter:
    def __init__(
        self,
        backend: Any,
        *,
        id_keys: Optional[List[str]] = None,
        score_keys: Optional[List[str]] = None,
        sink: Optional[TelemetrySink] = None,
    ):
        self.backend = backend
        self.id_keys = id_keys or ["id", "doc_id", "docId", "sid", "sent_id"]
        self.score_keys = score_keys or ["score", "relevance", "sim", "s"]
        self.sink = sink

    def _normalize_hit(self, raw: Any) -> Optional[Hit]:
        if isinstance(raw, Hit):
            return raw
        if not isinstance(raw, dict):
            return None
        hid = None
        for k in self.id_keys:
            if raw.get(k) is not None:
                hid = str(raw[k])
                break
        if hid is None:
            return None
        score = 0.0
        for k in self.score_keys:
            v = raw.get(k)
            if isinstance(v, (int, float)):
                score = float(v)
                break
        meta = raw.get("meta")
        if not isinstance(meta, dict):
            meta = {k: v for k, v in raw.items()
                    if k not in set(self.id_keys) | set(self.score_keys)}
        return Hit(id=hid, score=score, meta=meta)

    def retrieve(self, req: RetrievalIn) -> RetrievalOut:
        trace_id = getattr(req, "trace_id", None) or "trace-adapter"
        with span("RetrievalAdapter/normalize", self.sink, trace_id):
            out = self.backend.retrieve(req)
            raw_hits: List[Any]
            diagnostics: Dict[str, Any] = {}
            if isinstance(out, RetrievalOut):
                raw_hits = list(out.hits)
                diagnostics = dict(out.diagnostics or {})
            elif isinstance(out, dict):
                raw_hits = list(out.get("hits") or [])
                diagnostics = dict(out.get("diagnostics") or {})
            elif isinstance(out, list):
                raw_hits = out
            else:
                raw_hits = []
            hits = [h for h in (self._normalize_hit(r) for r in raw_hits) if h]
            return RetrievalOut(hits=hits, diagnostics=diagnostics)
