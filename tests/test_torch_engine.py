"""The whole slice: TorchQueryEngine vs the JAX TPUQueryEngine on the CPU.

On the tie-free corpus with the exact settings of the JAX sharded-hybrid
contract (parallel/sharded_hybrid.py dryrun_check), with the compact graph
pinned on the JAX side: ids must be identical and scores within atol 1e-5
(f32 sums in other orders: embedding norms, einsum dot products).
"""
import numpy as np
import pytest

from chip_smoke import compare_topk
from a_modular_rag_framework_torch.engine import EngineConfig as TConfig
from a_modular_rag_framework_torch.engine import TorchQueryEngine
from a_modular_rag_framework_torch.index import SentenceCorpus as TCorpus
from a_modular_rag_framework_torch.index import build_packed_index as t_build
from a_modular_rag_framework_tpu.core.dataset_loader import \
    SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.engine.query_engine import (EngineConfig,
                                                             TPUQueryEngine)
from a_modular_rag_framework_tpu.eval.harness import evaluate_retrieval
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
from a_modular_rag_framework_tpu.parallel.sharded_hybrid import _tie_free_corpus

ATOL = 1e-5


@pytest.fixture(scope="module")
def tie_free():
    corpus, queries = _tie_free_corpus()
    j_idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    t_idx = t_build(TCorpus(docs=list(corpus.docs)), embed_dim=32,
                    embed_dtype="float32")
    return j_idx, t_idx, queries


def _exact_kw(two_stage):
    kw = dict(top_k=10, pool_k=64, graph_window=2, bm25_term_topm=4096,
              batch_buckets=(8,), graph_pool_exact=True, graph_impl="compact",
              graph_compact_cap=64, graph_wave_dtype="float32")
    if two_stage:
        kw.update(alpha_text=0.15, alpha_graph=0.7, alpha_dense=0.15,
                  order_alphas=(0.4, 0.2, 0.4))
    return kw


def _assert_same(r_t, r_j):
    np.testing.assert_array_equal(r_t.hits.ids, np.asarray(r_j.hits.ids))
    np.testing.assert_allclose(r_t.hits.scores, np.asarray(r_j.hits.scores),
                               atol=ATOL)
    np.testing.assert_allclose(r_t.channel_norms,
                               np.asarray(r_j.channel_norms), atol=ATOL)
    for key in ("bm25_candidates", "graph_candidates", "dense_scored",
                "batch_bucket", "graph_window_used", "pool"):
        assert r_t.diagnostics[key] == r_j.diagnostics[key], key


@pytest.mark.parametrize("two_stage", [False, True])
@pytest.mark.parametrize("seeds", ["derived", "explicit"])
def test_hybrid_matches_jax_on_tie_free_corpus(tie_free, two_stage, seeds):
    j_idx, t_idx, queries = tie_free
    kw = _exact_kw(two_stage)
    j_eng = TPUQueryEngine(j_idx, config=EngineConfig(**kw))
    t_eng = TorchQueryEngine(t_idx, device="cpu", config=TConfig(**kw))
    call = {}
    if seeds == "explicit":
        call["seed_rows"] = [[(3 * i) % j_idx.n_docs, (7 * i + 1) % j_idx.n_docs]
                             for i in range(len(queries))]
    _assert_same(t_eng.query_batch(queries, top_k=10, **call),
                 j_eng.query_batch(queries, top_k=10, **call))


def test_hybrid_with_expansions_and_windows_matches_jax(tie_free):
    """E > 1 query variants (max-merged) and graph windows 0 and 1."""
    j_idx, t_idx, queries = tie_free
    kw = _exact_kw(False)
    j_eng = TPUQueryEngine(j_idx, config=EngineConfig(**kw))
    t_eng = TorchQueryEngine(t_idx, device="cpu", config=TConfig(**kw))
    exp = [[queries[(i + 1) % len(queries)]] for i in range(len(queries))]
    for window in (0, 1):
        _assert_same(
            t_eng.query_batch(queries, expansions=exp, graph_window=window),
            j_eng.query_batch(queries, expansions=exp, graph_window=window))


def test_dense_only_matches_jax(tie_free):
    """query_dense_batch vs the JAX engine's XLA path (use_pallas=False).
    Hash embeddings tie exactly between near-identical sentences, and the
    two frameworks' normalized embeddings differ by ulps, so ties compare
    as sets (the same check chip_smoke.py applies on the card)."""
    j_idx, t_idx, queries = tie_free
    j_eng = TPUQueryEngine(j_idx, config=EngineConfig(batch_buckets=(8,)))
    t_eng = TorchQueryEngine(t_idx, device="cpu",
                             config=TConfig(batch_buckets=(8,)))
    r_j = j_eng.query_dense_batch(queries, top_k=7, use_pallas=False)
    r_t = t_eng.query_dense_batch(queries, top_k=7)
    assert r_t.diagnostics["mode"] == "dense_only"
    compare_topk(r_t.hits.ids, r_t.hits.scores, np.asarray(r_j.hits.ids),
                 np.asarray(r_j.hits.scores), atol=1e-6)


def test_dense_matmul_formulation_agrees_with_pool(tie_free):
    _, t_idx, queries = tie_free
    kw = _exact_kw(False)
    pool = TorchQueryEngine(t_idx, device="cpu",
                            config=TConfig(**kw, dense_impl="pool"))
    mm = TorchQueryEngine(t_idx, device="cpu",
                          config=TConfig(**kw, dense_impl="matmul"))
    r_p, r_m = pool.query_batch(queries), mm.query_batch(queries)
    np.testing.assert_array_equal(r_m.hits.ids, r_p.hits.ids)
    np.testing.assert_allclose(r_m.hits.scores, r_p.hits.scores, atol=ATOL)


@pytest.fixture(scope="module")
def synthetic():
    samples = SyntheticHotpotQALoader({"count": 40, "seed": 7,
                                       "n_distractors": 6,
                                       "collide_entities": True}).load()
    j_idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                               embed_dim=64, embed_dtype="bfloat16")
    t_idx = t_build(TCorpus.from_hotpotqa(samples), embed_dim=64,
                    embed_dtype="bfloat16")
    return samples, j_idx, t_idx


def test_evaluate_retrieval_recall_equal(synthetic):
    """eval.harness drives both engines unchanged; the bench's scale
    operating point, compact graph pinned on the JAX side."""
    samples, j_idx, t_idx = synthetic
    kw = dict(top_k=10, pool_k=200, graph_window=2, batch_buckets=(16,),
              query_df_ratio_max=0.05, bm25_term_topm=16,
              graph_compact_cap=128, graph_impl="compact", dense_impl="pool",
              alpha_text=0.15, alpha_graph=0.70, alpha_dense=0.15,
              order_alphas=(0.4, 0.2, 0.4))
    j_eng = TPUQueryEngine(j_idx, config=EngineConfig(**kw))
    t_eng = TorchQueryEngine(t_idx, device="cpu", config=TConfig(**kw))
    r_j = evaluate_retrieval(j_eng, samples, k=10, batch_size=16)
    r_t = evaluate_retrieval(t_eng, samples, k=10, batch_size=16)
    assert r_t["n"] == r_j["n"] == len(samples)
    assert r_t["recall_at_10"] == r_j["recall_at_10"]
    assert r_t["recall_at_10"] > 0.5
    assert abs(r_t["mrr"] - r_j["mrr"]) < 1e-6


def test_pipelined_and_async_match_sync(synthetic):
    samples, _, t_idx = synthetic
    eng = TorchQueryEngine(t_idx, device="cpu",
                           config=TConfig(top_k=10, batch_buckets=(8,),
                                          graph_window=2))
    qs = [s["question"] for s in samples]
    batches = [qs[i:i + 8] for i in range(0, 32, 8)]
    try:
        piped = list(eng.query_batches_pipelined(batches))
    finally:
        eng.close()
    assert len(piped) == len(batches)
    for batch, r in zip(batches, piped):
        r_sync = eng.query_batch(batch)
        np.testing.assert_array_equal(r.hits.ids, r_sync.hits.ids)
        np.testing.assert_array_equal(r.hits.scores, r_sync.hits.scores)
        assert r.diagnostics["device_ms"] is None
        assert r_sync.diagnostics["device_ms"] is not None
    r_async = eng.query_batch_async(batches[0]).result()
    np.testing.assert_array_equal(r_async.hits.ids, piped[0].hits.ids)


def test_hydrate_hits_and_empty_batches(synthetic):
    _, _, t_idx = synthetic
    eng = TorchQueryEngine(t_idx, device="cpu",
                           config=TConfig(top_k=5, batch_buckets=(4,)))
    r = eng.query_batch(["Who was born in Veldoria?", "zzzz qqqq"])
    hits = eng.hydrate_hits(r, 0, extra_meta={"hop": 1})
    assert 0 < len(hits) <= 5
    assert hits[0]["id"].startswith("sent::") and hits[0]["meta"]["hop"] == 1
    assert {"score_text_norm", "score_graph_norm",
            "score_dense_norm"} <= set(hits[0]["meta"])
    empty = eng.query_batch([])
    assert empty.hits.ids.shape == (0, 5)
    assert eng.query_dense_batch([]).hits.ids.shape[0] == 0
    assert eng.device_bytes() > 0


@pytest.mark.parametrize("field,value,exc", [
    ("graph_impl", "dense", NotImplementedError),
    ("fusion_impl", "dense", NotImplementedError),
    ("bm25_impl", "scatter", NotImplementedError),
    ("sparse_impl", "splade", NotImplementedError),
    ("graph_impl", "compcat", ValueError),
    ("dense_impl", "mamtul", ValueError),
])
def test_unported_or_unknown_formulations_raise(tie_free, field, value, exc):
    _, t_idx, _ = tie_free
    with pytest.raises(exc):
        TorchQueryEngine(t_idx, device="cpu", config=TConfig(**{field: value}))


def test_engine_requires_explicit_device(tie_free):
    _, t_idx, _ = tie_free
    with pytest.raises(TypeError):
        TorchQueryEngine(t_idx, device=None)


def test_compare_topk_accepts_only_tie_swaps():
    ids = np.array([[5, 3, 9, 1]])
    s = np.array([[0.9, 0.5, 0.5, 0.1]], np.float32)
    assert compare_topk(ids, s, np.array([[5, 9, 3, 1]]), s, 1e-6)[1] == [0]
    with pytest.raises(AssertionError):
        compare_topk(ids, s, np.array([[3, 5, 9, 1]]), s, 1e-6)
    with pytest.raises(AssertionError):
        compare_topk(ids, s, ids, s + 1e-3, 1e-6)
