"""The port's pydantic-free contracts equal the JAX package's pydantic ones.

For each of the thirteen contracts the same keyword arguments build both
models and ``model_dump()`` is equal (exactly: the values are host data).
The behaviours the package relies on are held one by one: dicts coerced
into nested models, unknown keys ignored, a missing required field raises,
an int given for a float dumps as a float, the dump shares no container
with the object, and `HitBatch.hydrate`.
"""
import numpy as np
import pytest

from a_modular_rag_framework_torch.core import dto as t_dto
from a_modular_rag_framework_tpu.core import dto as j_dto

HIT = {"id": "sent::A::0", "score": 1, "meta": {"text": "x", "nested": {"a": [1, 2]}}}
EVID = {"channel": "embed_sim", "score": 1, "meta": {"k": [1]}}

CASES = {
    "GraphBuildIn": [
        {"trace_id": "t"},
        {"trace_id": "t", "question_text": "q", "context": [["A", ["s1", "s2"]]],
         "graph_id": "g", "nodes": [{"id": "n"}], "edges": [{"source": "a"}],
         "extra": {"policy": {"x": 1}}},
    ],
    "GraphBuildOut": [
        {"graph_id": "g", "node_count": 3, "edge_count": 2},
        {"graph_id": "g", "node_count": 3, "edge_count": 2, "nodes": [{"id": "n"}],
         "edges": [], "provenance": {"p": 1}, "diagnostics": {"d": [1]},
         "extra": {"e": 2}},
    ],
    "RetrievalIn": [
        {"query": "q", "trace_id": "t"},
        {"query": "q", "trace_id": "t", "graph_id": "g", "top_k": 5,
         "graph_window": 2},
    ],
    "Hit": [{"id": "a", "score": 0.5}, HIT],
    "RetrievalOut": [
        {},
        {"hits": [HIT, {"id": "b", "score": 0.25}], "diagnostics": {"q": ["x"]},
         "model": "m"},
    ],
    "HitBatch": [{"ids": [[1, -1]], "scores": [[0.5, 0.0]]}],
    "ReasoningIn": [
        {"question": "q", "trace_id": "t"},
        {"question": "q", "trace_id": "t", "hits": [HIT], "graph_id": "g"},
    ],
    "ReasoningOut": [
        {"answer": "a"},
        {"answer": "a", "evidence_used": [HIT], "steps": [{"s": 1}], "model": "m"},
    ],
    "VerifyIn": [
        {"answer": "a"},
        {"answer": "a", "evidence": [HIT], "question": "q", "query": "q2",
         "graph_id": "g", "trace_id": "t", "retry_round": 1},
    ],
    "VerifyOut": [
        {"status": "pass"},
        {"status": "fail", "findings": [{"f": 1}], "model": "m", "ok": False,
         "score": 1, "issues": ["i"], "diagnostics": {"d": {"e": 1}},
         "coverage_score": 1, "consistency_score": 0.5,
         "hallucination_risk": 0, "final_score": 0.25, "verdict": "PASS",
         "self_consistency": {"runs": 2}, "recommended_action": "retry",
         "status_detail": "fail", "status_detail_label": "Fail"},
    ],
    "EdgeEvidence": [{"channel": "c", "score": 2}, EVID],
    "GraphNode": [
        {"id": "n", "type": "sentence", "text": "t"},
        {"id": "n", "type": "sentence", "text": "t", "meta": {"doc": "A"}},
    ],
    "GraphEdge": [
        {"source": "a", "target": "b", "type": "q_match"},
        {"source": "a", "target": "b", "type": "semantic_sim", "weight": 1,
         "meta": {"m": 1}, "evidence": [EVID, {"channel": "p", "score": 0.8}]},
    ],
}
REQUIRED = {
    "GraphBuildIn": "trace_id", "GraphBuildOut": "node_count",
    "RetrievalIn": "trace_id", "Hit": "score", "HitBatch": "ids",
    "ReasoningIn": "question", "ReasoningOut": "answer", "VerifyIn": "answer",
    "VerifyOut": "status", "EdgeEvidence": "channel", "GraphNode": "text",
    "GraphEdge": "target",
}


def test_every_contract_is_here():
    names = {n for n, c in vars(j_dto).items()
             if isinstance(c, type) and issubclass(c, j_dto.BaseModel)
             and c is not j_dto.BaseModel}
    assert names == set(CASES) and len(names) == 13
    assert names == {n for n, c in vars(t_dto).items()
                     if isinstance(c, type) and issubclass(c, t_dto.Model)
                     and c is not t_dto.Model}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_kwargs_same_dump(name):
    for kwargs in CASES[name]:
        t = getattr(t_dto, name)(**kwargs)
        j = getattr(j_dto, name)(**kwargs)
        assert t.model_dump() == j.model_dump()
        # unknown keys are ignored by both
        assert (getattr(t_dto, name)(**kwargs, not_a_field=1).model_dump()
                == getattr(j_dto, name)(**kwargs, not_a_field=1).model_dump())


@pytest.mark.parametrize("name", sorted(REQUIRED))
def test_missing_required_field_raises(name):
    kwargs = dict(CASES[name][-1])
    del kwargs[REQUIRED[name]]
    with pytest.raises(ValueError):  # pydantic's ValidationError is one
        getattr(j_dto, name)(**kwargs)
    with pytest.raises(ValueError):
        getattr(t_dto, name)(**kwargs)


@pytest.mark.parametrize("mod", [t_dto, j_dto], ids=["port", "jax"])
def test_nested_dicts_become_models_and_ints_become_floats(mod):
    r = mod.ReasoningIn(question="q", trace_id="t", hits=[HIT, mod.Hit(**HIT)])
    assert all(isinstance(h, mod.Hit) for h in r.hits)
    assert isinstance(r.hits[0].score, float)
    assert r.hits[0].meta["text"] == "x"
    e = mod.GraphEdge(source="a", target="b", type="t", weight=1, evidence=[EVID])
    assert isinstance(e.evidence[0], mod.EdgeEvidence)
    d = e.model_dump()
    assert isinstance(d["weight"], float) and isinstance(
        d["evidence"][0]["score"], float)
    out = mod.RetrievalOut(hits=[mod.Hit(**h) for h in [HIT]])
    assert out.model_dump()["hits"][0]["id"] == HIT["id"]
    assert mod.Hit(**HIT) == mod.Hit(**HIT)


@pytest.mark.parametrize("mod", [t_dto, j_dto], ids=["port", "jax"])
def test_dump_shares_nothing_with_the_object(mod):
    v = mod.VerifyIn(answer="a", evidence=[HIT])
    d = v.model_dump()
    d["evidence"][0]["meta"]["text"] = "changed"
    d["evidence"][0]["meta"]["nested"]["a"].append(3)
    d["evidence"].append("x")
    assert v.evidence[0].meta["text"] == "x"
    assert v.evidence[0].meta["nested"]["a"] == [1, 2]
    assert len(v.evidence) == 1
    # defaults are per instance
    a, b = mod.Hit(id="a", score=0.0), mod.Hit(id="b", score=0.0)
    a.meta["k"] = 1
    assert b.meta == {}


def test_hitbatch_hydrate_equal():
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 9, size=(3, 6)).astype(np.int32)
    scores = rng.random((3, 6)).astype(np.float32)
    t = t_dto.HitBatch(ids=ids, scores=scores)
    j = j_dto.HitBatch(ids=ids, scores=scores)
    for row in range(3):
        for extra in (None, {"src": "x", "row": -1}):
            kw = dict(id_fn=lambda i: f"sent::{i}",
                      meta_fn=lambda i: {"row": i}, extra_meta=extra)
            th, jh = t.hydrate(row, **kw), j.hydrate(row, **kw)
            assert [h.model_dump() for h in th] == [h.model_dump() for h in jh]
            assert len(th) == int((ids[row] >= 0).sum())


def test_retrieval_in_defaults_and_verify_out_fields():
    r = t_dto.RetrievalIn(query="q", trace_id="t")
    assert r.top_k == 20 and r.graph_id == "" and r.graph_window is None
    v = t_dto.VerifyOut(status="pass", verdict="PASS", final_score=0.9,
                        status_detail="high_conf_pass")
    assert list(v.model_dump()) == list(
        j_dto.VerifyOut(status="pass").model_dump())
