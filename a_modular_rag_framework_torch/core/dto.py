"""Core data contracts without pydantic.

Port of ``a_modular_rag_framework_tpu/core/dto.py``, whose contracts are
pydantic models: the same thirteen classes with the same fields and
defaults, over one small base (`Model`) that gives what the package uses of
pydantic. That is keyword construction (unknown keys are ignored, a missing
required field raises, dicts become nested models where a field is typed as
a list of them, an int given for a float comes out as a float) and
``model_dump()``, which returns plain containers that share nothing with
the object.

A batch of top-K hits travels as arrays (`HitBatch`) and becomes per-hit
`Hit` objects only at the host boundary (`HitBatch.hydrate`,
`TorchQueryEngine.hydrate_hits`).
"""
from __future__ import annotations

import typing
from typing import Any, Dict, List, Optional

import numpy as np

_MISSING = object()


class ValidationError(ValueError):
    """A required field is missing or a nested value cannot be coerced."""


class _factory:
    """Marks a class attribute as a per-instance default (``list``/``dict``)."""

    def __init__(self, fn):
        self.fn = fn


def _coercer(tp):
    """The conversion a field of annotated type ``tp`` applies on input."""
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union:  # Optional[X]
        inner = [_coercer(a) for a in args if a is not type(None)]
        return lambda v: v if v is None or len(inner) != 1 else inner[0](v)
    if origin in (list, List):
        item = _coercer(args[0]) if args else (lambda v: v)
        return lambda v: [item(x) for x in v]
    if origin in (dict, Dict):
        return lambda v: dict(v)
    if isinstance(tp, type) and issubclass(tp, Model):
        def to_model(v, tp=tp):
            if isinstance(v, tp):
                return v
            if isinstance(v, Model):
                v = v.model_dump()
            if not isinstance(v, typing.Mapping):
                raise ValidationError(
                    f"{tp.__name__}: cannot build from {type(v).__name__}")
            return tp(**v)
        return to_model
    if tp is float:
        return lambda v: v if isinstance(v, bool) else float(v)
    return lambda v: v


def _dump(v):
    if isinstance(v, Model):
        return v.model_dump()
    if isinstance(v, dict):
        return {k: _dump(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_dump(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_dump(x) for x in v)
    return v


class Model:
    """Base of the contracts: fields are the class annotations, in order."""

    _fields: Optional[Dict[str, Any]] = None  # name -> (coercer, default)

    @classmethod
    def _field_table(cls) -> Dict[str, Any]:
        if cls.__dict__.get("_fields") is None:
            hints = typing.get_type_hints(cls)
            cls._fields = {
                name: (_coercer(tp), getattr(cls, name, _MISSING))
                for name, tp in hints.items()
                if not name.startswith("_")
            }
        return cls._fields

    def __init__(self, **data: Any):
        missing = []
        for name, (coerce, default) in self._field_table().items():
            if name in data:
                value = coerce(data[name])
            elif default is _MISSING:
                missing.append(name)
                continue
            elif isinstance(default, _factory):
                value = default.fn()
            else:
                value = default
            object.__setattr__(self, name, value)
        if missing:
            raise ValidationError(
                f"{type(self).__name__}: missing required field(s) "
                + ", ".join(missing))

    def model_dump(self) -> Dict[str, Any]:
        return {name: _dump(getattr(self, name))
                for name in self._field_table()}

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return all(getattr(self, n) == getattr(other, n)
                   for n in self._field_table())

    __hash__ = None

    def __repr__(self):
        body = ", ".join(f"{n}={getattr(self, n)!r}"
                         for n in self._field_table())
        return f"{type(self).__name__}({body})"


# ========= Graph build =========


class GraphBuildIn(Model):
    trace_id: str
    question_text: str = ""
    context: List[Any] = _factory(list)

    graph_id: Optional[str] = None
    nodes: List[Dict[str, Any]] = _factory(list)
    edges: List[Dict[str, Any]] = _factory(list)

    extra: Dict[str, Any] = _factory(dict)


class GraphBuildOut(Model):
    graph_id: str
    node_count: int
    edge_count: int

    nodes: Optional[List[Dict[str, Any]]] = None
    edges: Optional[List[Dict[str, Any]]] = None
    provenance: Optional[Dict[str, Any]] = None
    diagnostics: Optional[Dict[str, Any]] = None

    extra: Dict[str, Any] = _factory(dict)


# ========= Retrieval =========


class RetrievalIn(Model):
    query: str
    graph_id: str = ""
    top_k: int = 20
    trace_id: str
    # optional per-request override of the graph expansion window (hops)
    graph_window: Optional[int] = None


class Hit(Model):
    id: str
    score: float
    meta: Dict[str, Any] = _factory(dict)


class RetrievalOut(Model):
    hits: List[Hit] = _factory(list)
    diagnostics: Dict[str, Any] = _factory(dict)
    model: Optional[str] = None


class HitBatch(Model):
    """A batch of top-K hits as arrays.

    ``ids`` are row indices into a corpus table (int32, shape [B, K]);
    ``scores`` are fused relevance scores (float32, shape [B, K]).
    ``-1`` ids mark padding (fewer than K real candidates). Host code
    converts a row to `Hit`s with `hydrate` and a corpus metadata lookup.
    """

    ids: Any  # np.ndarray int32 [B, K]
    scores: Any  # np.ndarray float32 [B, K]

    def hydrate(
        self,
        row: int,
        id_fn,
        meta_fn,
        extra_meta: Optional[Dict[str, Any]] = None,
    ) -> List[Hit]:
        """Convert one batch row into host `Hit`s, skipping padding."""
        ids = np.asarray(self.ids)[row]
        scores = np.asarray(self.scores)[row]
        hits: List[Hit] = []
        for i, s in zip(ids.tolist(), scores.tolist()):
            if i < 0:
                continue
            meta = dict(meta_fn(i) or {})
            if extra_meta:
                meta.update(extra_meta)
            hits.append(Hit(id=str(id_fn(i)), score=float(s), meta=meta))
        return hits


# ========= Reasoning =========


class ReasoningIn(Model):
    question: str
    hits: List[Hit] = _factory(list)
    graph_id: str = ""
    trace_id: str


class ReasoningOut(Model):
    answer: str
    evidence_used: List[Hit] = _factory(list)
    steps: List[Dict[str, Any]] = _factory(list)
    model: Optional[str] = None


# ========= Verification =========


class VerifyIn(Model):
    answer: str
    evidence: List[Hit] = _factory(list)
    question: Optional[str] = None
    query: Optional[str] = None
    graph_id: Optional[str] = None
    trace_id: Optional[str] = None
    retry_round: int = 0


class VerifyOut(Model):
    """Verifier output.

    ``status``: coarse "pass" | "fail" | "warn".
    ``status_detail``: fine-grained state: "fail", "high_conf_pass",
    "low_conf_pass", "unknown_pass" (see `modules.verification`).
    ``verdict``: fine verdict: PASS | PASS-WITH-NOISE | PARTIAL |
    FAIL-CONTRADICTED | FAIL-UNSUPPORTED | INCONCLUSIVE.
    """

    status: str
    findings: List[Dict[str, Any]] = _factory(list)
    model: Optional[str] = None

    ok: Optional[bool] = None
    score: Optional[float] = None
    issues: List[str] = _factory(list)
    diagnostics: Dict[str, Any] = _factory(dict)

    coverage_score: Optional[float] = None
    consistency_score: Optional[float] = None
    hallucination_risk: Optional[float] = None
    final_score: Optional[float] = None

    verdict: Optional[str] = None
    self_consistency: Optional[Dict[str, Any]] = None

    recommended_action: Optional[str] = None

    status_detail: Optional[str] = None
    status_detail_label: Optional[str] = None


# ========= Graph atoms =========


class EdgeEvidence(Model):
    channel: str
    score: float
    meta: Dict[str, Any] = _factory(dict)


class GraphNode(Model):
    id: str
    type: str
    text: str
    meta: Dict[str, Any] = _factory(dict)


class GraphEdge(Model):
    source: str
    target: str
    type: str
    weight: float = 1.0
    meta: Dict[str, Any] = _factory(dict)
    evidence: List[EdgeEvidence] = _factory(list)
