"""The rest of the JAX package's surface in the port, on the CPU: the
per-question graph store, the request adapters and the v2 request schema,
the retrieval adapter, the similarity helpers, `build_neighbor_table`, the
reference harness's metric layer, and the engine's `profile`,
`encode_queries`, `qmatch_seed_rows` and NaN switch.

Each is held to the JAX package where the JAX function exists: host
outputs exactly, graph-store scores within 1e-6 (the same f32 decay
table), similarities within 1e-6 (the same numpy code).
"""
import json
import re

import numpy as np
import pytest
import torch

from a_modular_rag_framework_torch.adapters import graph_request_adapter as t_adapt
from a_modular_rag_framework_torch.core.dataset_loader import (
    SyntheticHotpotQALoader)
from a_modular_rag_framework_torch.core.dto import GraphBuildIn, RetrievalIn
from a_modular_rag_framework_torch.engine import EngineConfig, TorchQueryEngine
from a_modular_rag_framework_torch.eval import reference_harness as t_ref
from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                 build_packed_index)
from a_modular_rag_framework_torch.modules.graph_construction.flow import (
    GraphConstructionFlow)
from a_modular_rag_framework_torch.modules.graph_construction.impl_arrays import (
    GraphConstructionArrays)
from a_modular_rag_framework_torch.modules.retrieval import (RetrievalAdapter,
                                                             graph_store)
from a_modular_rag_framework_torch.ops.graph import build_neighbor_table
from a_modular_rag_framework_torch.schemas import (AssembleGraphRequestV2,
                                                   Inputs, Sentence)
from a_modular_rag_framework_torch.utils import similarity as t_sim
from a_modular_rag_framework_tpu.adapters import graph_request_adapter as j_adapt
from a_modular_rag_framework_tpu.core.dto import RetrievalIn as JRetrievalIn
from a_modular_rag_framework_tpu.engine.query_engine import (
    EngineConfig as JEngineConfig)
from a_modular_rag_framework_tpu.engine.query_engine import TPUQueryEngine
from a_modular_rag_framework_tpu.eval import reference_harness as j_ref
from a_modular_rag_framework_tpu.index.packed import PackedIndex as JPackedIndex
from a_modular_rag_framework_tpu.modules.retrieval import (
    RetrievalAdapter as JRetrievalAdapter)
from a_modular_rag_framework_tpu.modules.retrieval import (
    graph_store as j_graph_store)
from a_modular_rag_framework_tpu.ops.graph import (
    build_neighbor_table as j_build_neighbor_table)
from a_modular_rag_framework_tpu.utils import similarity as j_sim

GRAPH_ATOL = 1e-6
SIM_ATOL = 1e-6
POLICY = {"assembly_policy": {"channels": {"q_overlap": 1.0, "embed_sim": 1.0,
                                           "entity_link": 0.6,
                                           "position_prior": 0.2},
                              "edge_min_vote": 0, "max_edges_per_node": 0}}


# ---------------- graph store ----------------


@pytest.fixture(scope="module")
def stored_graph(tmp_path_factory):
    """A per-question graph written by the port's flow (the production
    assembly policy) to graph.json."""
    root = tmp_path_factory.mktemp("graph_store")
    impl = GraphConstructionArrays(root_dir=str(root), write_analysis=False)
    flow = GraphConstructionFlow(impl=impl, edge_builder_kwargs=dict(
        POLICY, device="cpu"))
    context = [("Doc A", ["Alice went home.", "Alice met Bob there.",
                          "The end came later."]),
               ("Doc B", ["Bob lives in Rome.", "Rome is old.",
                          "Old towns have walls."])]
    flow.build(GraphBuildIn(trace_id="t", question_text="Where does Bob live?",
                            context=context, graph_id="g9"))
    return str(root)


def test_graph_store_roundtrip(stored_graph):
    g = graph_store.load_graph_json(stored_graph, "g9")
    nodes_by_id, fwd, bwd, texts, qmatch = graph_store.build_index(g)
    assert qmatch, "q_match seeds missing"
    assert any("Rome" in t for t in texts.values())
    expanded = graph_store.expand_qmatch_neighbors(
        "Where does Bob live?", nodes_by_id, fwd, bwd, texts,
        explicit_qmatch=qmatch, window=1, device="cpu")
    assert expanded
    scores = sorted({round(s, 2) for s, _ in expanded.values()}, reverse=True)
    assert scores[0] == 1.0  # seeds
    if len(scores) > 1:
        assert scores[1] == 0.7  # one-hop decay


def test_graph_store_missing_graph(tmp_path):
    g = graph_store.load_graph_json(str(tmp_path / "nonexistent"), "nope")
    assert g == {"nodes": [], "edges": []}
    nodes_by_id, fwd, bwd, texts, qmatch = graph_store.build_index(g)
    assert graph_store.expand_qmatch_neighbors(
        "q", nodes_by_id, fwd, bwd, texts, device="cpu") == {}


def test_graph_store_fallback_token_seeds():
    g = {"nodes": [{"id": "D::sent0", "type": "sentence", "text": "zebra stripes"},
                   {"id": "D::sent1", "type": "sentence", "text": "lion mane"}],
         "edges": [{"source": "D::sent0", "target": "D::sent1",
                    "type": "next_in_doc"}]}
    nodes_by_id, fwd, bwd, texts, qmatch = graph_store.build_index(g)
    assert not qmatch
    out = graph_store.expand_qmatch_neighbors(
        "tell me about zebra", nodes_by_id, fwd, bwd, texts, window=1,
        device="cpu")
    assert out["D::sent0"][0] == 1.0
    assert out["D::sent1"][0] == pytest.approx(0.7)


@pytest.mark.parametrize("window", [0, 1, 2, 4])
@pytest.mark.parametrize("explicit", [True, False])
def test_expand_qmatch_neighbors_matches_jax(stored_graph, window, explicit):
    g = graph_store.load_graph_json(stored_graph, "g9")
    assert g == j_graph_store.load_graph_json(stored_graph, "g9")
    t_parts = graph_store.build_index(g)
    j_parts = j_graph_store.build_index(g)
    assert t_parts == j_parts
    nodes_by_id, fwd, bwd, texts, qmatch = t_parts
    kw = dict(explicit_qmatch=qmatch if explicit else None, window=window)
    t = graph_store.expand_qmatch_neighbors(
        "Where does Bob live in Rome?", nodes_by_id, fwd, bwd, texts,
        device="cpu", **kw)
    j = j_graph_store.expand_qmatch_neighbors(
        "Where does Bob live in Rome?", nodes_by_id, fwd, bwd, texts, **kw)
    assert t and sorted(t) == sorted(j)
    for sid, (score, meta) in t.items():
        assert score == pytest.approx(j[sid][0], abs=GRAPH_ATOL)
        assert meta == j[sid][1]


def test_expand_qmatch_neighbors_without_a_device_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    g = {"nodes": [{"id": "D::sent0", "type": "sentence", "text": "zebra"}],
         "edges": []}
    with pytest.raises(RuntimeError, match="CUDA"):
        graph_store.expand_qmatch_neighbors("zebra",
                                            *graph_store.build_index(g)[:4])


@pytest.mark.parametrize("n,max_degree", [(6, 2), (40, 3), (40, 8)])
def test_build_neighbor_table_matches_jax(n, max_degree):
    rng = np.random.default_rng(n * max_degree)
    src = rng.integers(0, n, size=3 * n)
    dst = rng.integers(0, n, size=3 * n)
    t = build_neighbor_table(n, src, dst, max_degree)
    np.testing.assert_array_equal(t, j_build_neighbor_table(n, src, dst,
                                                            max_degree))
    assert t.dtype == np.int32 and t.shape == (n, max_degree)


# ---------------- adapters, schema, retrieval adapter ----------------


def _masked(dump):
    """model_dump() with the uuid part of graph_id masked."""
    dump = json.loads(json.dumps(dump))
    dump["graph_id"] = re.sub(r"-[0-9a-f]{8}$", "-<uuid>", dump["graph_id"])
    return dump


def test_request_adapters():
    assert t_adapt.normalize_title("  A b/c ") == "A_b_c"
    v2 = t_adapt.upgrade_to_v2({"question": "Who?", "nodes": [], "edges": []},
                               default_trace_id="tr")
    assert v2.inputs.sentences[0].text == "Who?"
    v2b = t_adapt.hotpotqa_to_v2({"context": [["Doc A", ["s0", "s1"]]]},
                                 trace_id="tr")
    kinds = {e["kind"] for e in v2b.inputs.edges}
    assert kinds == {"q2doc", "doc2sent", "next_sent"}


@pytest.mark.parametrize("raw", [
    {"question": "Who?", "nodes": [], "edges": []},
    {"graph_id": "g1", "sentences": ["a b", "c"], "nodes": [{"id": "n"}]},
    {"inputs": {"sentences": "one sentence",
                "edges": [{"source": "a", "target": "b"}]}},
    {"inputs": {"nodes": [{"id": "x"}]}, "edges": [{"source": "x"}]},
    {},
], ids=["question", "sentences", "string", "inputs", "empty"])
def test_upgrade_to_v2_dump_matches_jax(raw):
    t = t_adapt.upgrade_to_v2(raw, default_trace_id="tr")
    j = j_adapt.upgrade_to_v2(raw, default_trace_id="tr")
    assert isinstance(t, AssembleGraphRequestV2)
    assert _masked(t.model_dump()) == _masked(j.model_dump())


@pytest.mark.parametrize("n_docs", [0, 1, 3])
def test_hotpotqa_to_v2_dump_matches_jax(n_docs):
    sample = SyntheticHotpotQALoader({"count": 1, "seed": 4}).load()[0]
    ctx = {"context": sample["context"][:n_docs]}
    t = t_adapt.hotpotqa_to_v2(ctx, trace_id="tr")
    j = j_adapt.hotpotqa_to_v2(ctx, trace_id="tr")
    assert _masked(t.model_dump()) == _masked(j.model_dump())
    assert t.graph_id.startswith("graph-tr-")


def test_v2_schema_defaults_and_coercion():
    r = AssembleGraphRequestV2(graph_id="g")
    assert r.model_dump() == {"api_version": "v2", "graph_id": "g",
                              "inputs": {"sentences": [], "nodes": [],
                                         "edges": []}, "options": {}}
    # fresh containers per instance
    AssembleGraphRequestV2(graph_id="a").inputs.nodes.append({"id": 1})
    assert AssembleGraphRequestV2(graph_id="b").inputs.nodes == []
    # dicts become nested models
    r = AssembleGraphRequestV2(graph_id="g", inputs={
        "sentences": [{"id": "s", "text": "t"}]})
    assert isinstance(r.inputs, Inputs)
    assert r.inputs.sentences == [Sentence(id="s", text="t")]
    with pytest.raises(ValueError):
        AssembleGraphRequestV2()  # graph_id is required
    with pytest.raises(ValueError):
        Sentence(id="s")


class _FakeBackend:
    def __init__(self, out):
        self.out = out

    def retrieve(self, req):
        return self.out


@pytest.mark.parametrize("shape", ["dict", "list", "other"])
def test_retrieval_adapter_normalizes_shapes(shape):
    raw = [{"doc_id": "d1", "relevance": 0.7, "text": "hello"},
           {"id": "d2", "score": 0.5, "meta": {"text": "world"}},
           {"sid": 3, "sim": 2, "doc": "x"},
           {"nonsense": True}, "not a dict"]
    out = {"dict": {"hits": raw, "diagnostics": {"x": 1}}, "list": raw,
           "other": 42}[shape]
    t = RetrievalAdapter(_FakeBackend(out)).retrieve(
        RetrievalIn(query="q", graph_id="", trace_id="t"))
    j = JRetrievalAdapter(_FakeBackend(out)).retrieve(
        JRetrievalIn(query="q", graph_id="", trace_id="t"))
    assert t.model_dump() == j.model_dump()
    if shape == "dict":
        assert [h.id for h in t.hits] == ["d1", "d2", "3"]
        assert t.hits[0].score == 0.7 and t.hits[0].meta.get("text") == "hello"
        assert t.diagnostics == {"x": 1}


# ---------------- similarity ----------------


def test_similarity_helpers_match_jax():
    pairs = [("alpha beta", "alpha gamma"), ("", "x"), ("same", "same")]
    for a, b in pairs:
        assert t_sim.compute_similarity_score(a, b) == \
            j_sim.compute_similarity_score(a, b)
    vecs = [([1.0, 2.0, 3.0], [3.0, 2.0, 1.0]), ([], [1.0]),
            ([0.0, 0.0], [1.0, 1.0])]
    for u, v in vecs:
        assert t_sim.cosine(u, v) == j_sim.cosine(u, v)
    emb = {"a": [1.0, 0.0], "b": [0.6, 0.8]}
    assert t_sim.embed_sim("a", "b", embed=emb.get) == pytest.approx(0.6)
    assert t_sim.embed_sim("a", "b", embed=emb.get) == j_sim.embed_sim(
        "a", "b", embed=emb.get)
    assert t_sim.embed_sim("abc", "abd") == j_sim.embed_sim("abc", "abd")


@pytest.mark.parametrize("with_vecs", [True, False])
def test_cosine_matrix_and_mmr_match_jax(with_vecs):
    rng = np.random.default_rng(7)
    E = rng.standard_normal((12, 8)).astype(np.float32)
    E[3] = 0.0  # a zero row stays finite
    np.testing.assert_allclose(t_sim.cosine_matrix(E), j_sim.cosine_matrix(E),
                               atol=SIM_ATOL)
    items = [(f"i{i}", float(rng.random()), E[i].tolist() if with_vecs
              else None) for i in range(12)]
    for top_k, lam in ((5, 0.7), (12, 0.3), (20, 1.0)):
        t = t_sim.mmr_diversify(items, top_k=top_k, lambda_weight=lam)
        j = j_sim.mmr_diversify(items, top_k=top_k, lambda_weight=lam)
        assert [x[0] for x in t] == [x[0] for x in j]
    assert t_sim.mmr_diversify([]) == []


# ---------------- reference harness ----------------


def test_canonical_sent_key_reference_spellings():
    for f in (t_ref.canonical_sent_key, j_ref.canonical_sent_key):
        assert f("sent::Doc A::3") == ("Doc A", "3")
        assert f("sent::Doc A::") == ("Doc A", "0")
        assert f("sent::Doc A#3::3") == ("Doc A", "3")
        assert f("sent::Doc A#0::") == ("Doc A", "0")
        assert f("sent::Doc A") is None
        assert f("sent::Doc::x") is None
        assert f("") is None


def test_score_hits_dedups_spellings():
    sample = {"supporting_facts": [["Doc A", 0], ["Doc B", 1]]}
    ids = ["sent::Doc X::2", "sent::Doc A#0::", "sent::Doc A::",
           "sent::Doc B::1"]
    r, rr = t_ref.score_hits(ids, sample, k=10)
    assert (r, rr) == (1.0, 0.5)
    assert (r, rr) == j_ref.score_hits(ids, sample, k=10)


def test_reference_harness_without_the_reference(tmp_path):
    with pytest.raises(FileNotFoundError, match="reference not found"):
        t_ref.import_reference(str(tmp_path / "absent"))
    # no default checkout: with no root named, it raises before any import
    for root in (None, ""):
        with pytest.raises(FileNotFoundError, match="no checkout named"):
            t_ref.import_reference(root)
    with pytest.raises(FileNotFoundError, match="no checkout named"):
        t_ref.run_baseline(reference_root=None, workdir=str(tmp_path / "w"))
    assert not (tmp_path / "w").exists()
    texts = ["a b c", "Sage Silverton was born in Zephyr Bay."]
    assert (t_ref.HashEmbedProvider(16).embed(texts=texts)
            == j_ref.HashEmbedProvider(16).embed(texts=texts))


def test_run_engine_eval_matches_jax(tmp_path):
    """The harness's own engine evaluation (the port's backend on the CPU)
    scores the same recall and MRR as the JAX package's on one corpus."""
    from a_modular_rag_framework_torch.cli.ingest_hotpotqa import ingest

    samples = SyntheticHotpotQALoader(
        {"count": 8, "seed": 5, "unique_entities": True,
         "n_distractors": 1}).load()
    docs = tmp_path / "docs.jsonl"
    ingest(samples, graph_root=tmp_path / "graph", docs_out=docs)
    kw = dict(docs_path=docs, graph_root=tmp_path / "graph", k=10,
              batch_size=8)
    t = t_ref.run_engine_eval(samples, device="cpu", **kw)
    j = j_ref.run_engine_eval(samples, **kw)
    assert (t["system"], t["backend"]) == ("torch_engine", "cpu")
    for key in ("n", "recall_at_10", "mrr", "batched_recall_at_10"):
        assert t[key] == pytest.approx(j[key], abs=1e-9), key


# ---------------- engine surface ----------------


@pytest.fixture(scope="module")
def engines():
    samples = SyntheticHotpotQALoader(
        {"count": 8, "seed": 5, "unique_entities": True,
         "n_distractors": 1}).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=32, embed_dtype="float32")
    return samples, idx


def test_encode_queries_and_qmatch_seed_rows_match_jax(engines, tmp_path):
    samples, idx = engines
    idx.save(str(tmp_path / "packed"))
    t = TorchQueryEngine(idx, device="cpu", config=EngineConfig(top_k=5))
    j = TPUQueryEngine(JPackedIndex.load(str(tmp_path / "packed")),
                       config=JEngineConfig(top_k=5))
    variants = [[s["question"], s["question"].lower()] for s in samples[:3]]
    variants.append([])
    t_emb, t_ids = t.encode_queries(variants, n_variants=2)
    j_emb, j_ids = j.encode_queries(variants, n_variants=2)
    np.testing.assert_allclose(t_emb, j_emb, atol=1e-6)
    np.testing.assert_array_equal(t_ids, j_ids)
    assert t_emb.dtype == np.float32 and t_ids.dtype == np.int32
    rows = list(range(idx.n_docs))
    for s in samples[:4]:
        got = t.qmatch_seed_rows(s["question"], rows)
        assert got and got == j.qmatch_seed_rows(s["question"], rows)


def test_profile_writes_a_trace_naming_the_engine_ranges(engines, tmp_path):
    samples, idx = engines
    eng = TorchQueryEngine(idx, device="cpu", config=EngineConfig(top_k=5))
    with eng.profile(str(tmp_path / "trace")) as prof:
        eng.query_batch([s["question"] for s in samples[:4]])
    assert prof is not None
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    names = {e.get("name") for e in json.loads(traces[0].read_text())[
        "traceEvents"]}
    assert {"engine/bm25_pool", "engine/graph", "engine/fusion"} <= names


@pytest.mark.parametrize("form", ["dense", "compact"])
def test_nan_switch_trips_on_a_planted_nan(engines, monkeypatch, form):
    samples, idx = engines
    cfg = EngineConfig(top_k=5, graph_impl=form)
    qs = [s["question"] for s in samples[:4]]
    clean = TorchQueryEngine(idx, device="cpu", config=cfg).query_batch(qs)
    rows = np.unique(clean.hits.ids[clean.hits.ids >= 0])
    poisoned = idx.embeddings.copy()
    poisoned[rows] = np.nan
    monkeypatch.setattr(idx, "embeddings", poisoned)
    # without the variable nothing checks: the min-max normalization drops
    # the NaN dense channel and finite (wrong) scores come back
    quiet = TorchQueryEngine(idx, device="cpu", config=cfg).query_batch(qs)
    assert np.isfinite(quiet.hits.scores).all()
    assert not np.allclose(quiet.hits.scores, clean.hits.scores)
    monkeypatch.setenv("AMRF_DEBUG_NANS", "1")
    with pytest.raises(FloatingPointError,
                       match="engine upload: .*index embeddings"):
        TorchQueryEngine(idx, device="cpu", config=cfg)
    # planted in the uploaded table: every program names its call
    monkeypatch.undo()  # the clean table again
    monkeypatch.setenv("AMRF_DEBUG_NANS", "1")
    eng = TorchQueryEngine(idx, device="cpu", config=cfg)
    assert eng._check_nans
    assert np.isfinite(eng.query_batch(qs).hits.scores).all()  # clean
    eng._emb[torch.from_numpy(rows).long()] = float("nan")
    with pytest.raises(FloatingPointError,
                       match="engine/query_batch: .*dense pool"):
        eng.query_batch(qs)
    with pytest.raises(FloatingPointError, match="engine/query_dense_batch"):
        eng.query_dense_batch(qs)
    with pytest.raises(FloatingPointError, match="engine/query_batch"):
        list(eng.query_batches_pipelined([qs[:2], qs[2:]]))
    eng.close()
    # the variable is read at construction
    monkeypatch.delenv("AMRF_DEBUG_NANS")
    assert not TorchQueryEngine(idx, device="cpu", config=cfg)._check_nans


def test_nan_switch_on_the_sharded_engine(engines, monkeypatch):
    from a_modular_rag_framework_torch.parallel import (ShardedHybridEngine,
                                                        build_mesh)

    samples, idx = engines
    qs = [s["question"] for s in samples[:4]]
    mesh = build_mesh({"data": 2}, devices=["cpu"] * 2)
    cfg = EngineConfig(top_k=5, batch_buckets=(8,))
    monkeypatch.setenv("AMRF_DEBUG_NANS", "1")
    eng = ShardedHybridEngine(idx, mesh=mesh, config=cfg)
    clean = eng.query_batch(qs)
    assert np.isfinite(clean.hits.scores).all()
    for shard in eng._shards[0]:
        shard["emb"][:] = float("nan")
    with pytest.raises(FloatingPointError,
                       match="engine/query_batch: .*dense pool"):
        eng.query_batch(qs)
