"""The whole slice: TorchQueryEngine vs the JAX TPUQueryEngine on the CPU.

On the tie-free corpus with the exact settings of the JAX sharded-hybrid
contract (parallel/sharded_hybrid.py dryrun_check): ids must be identical
and scores within atol 1e-5 (f32 sums in other orders: embedding norms,
einsum dot products, scatter-adds). Both forms of the program are held:
the compact one and the dense [B, N] one (JAX with an exact graph pool and
f32 waves, since the port's graph pool is always exact).
"""
import numpy as np
import pytest
import torch

from chip_smoke import compare_topk
from a_modular_rag_framework_torch.engine import EngineConfig as TConfig
from a_modular_rag_framework_torch.core.dto import Hit
from a_modular_rag_framework_torch.engine import TorchQueryEngine
from a_modular_rag_framework_torch.engine.query_engine import \
    use_compact_graph
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


# the dense [B, N] forms: the graph waves over the whole corpus, the
# exact graph pool, and every formulation that needs [B, N] buffers
DENSE_FORMS = {
    "auto": dict(graph_impl="auto"),
    "dense": dict(graph_impl="dense"),
    "dense_fusion": dict(graph_impl="dense", fusion_impl="dense"),
    "scatter_bm25": dict(graph_impl="dense", bm25_impl="scatter"),
    "matmul": dict(graph_impl="auto", dense_impl="matmul"),
    "frontier_cap": dict(graph_impl="dense", frontier_cap=8),
    "unweighted_seeds": dict(graph_impl="dense", graph_seed_weighted=False),
    "all_dense_two_stage": dict(graph_impl="dense", fusion_impl="dense",
                                bm25_impl="scatter", dense_impl="matmul",
                                order_alphas=(0.4, 0.2, 0.4)),
    "scatter_bm25_compact_graph": dict(graph_impl="compact",
                                       bm25_impl="scatter"),
}


@pytest.mark.parametrize("seeds", ["derived", "explicit"])
@pytest.mark.parametrize("form", list(DENSE_FORMS))
def test_dense_forms_match_jax_on_tie_free_corpus(tie_free, form, seeds):
    j_idx, t_idx, queries = tie_free
    kw = dict(_exact_kw(False), **DENSE_FORMS[form])
    j_eng = TPUQueryEngine(j_idx, config=EngineConfig(**kw))
    t_eng = TorchQueryEngine(t_idx, device="cpu", config=TConfig(**kw))
    call = {}
    if seeds == "explicit":
        call["seed_rows"] = [[(3 * i) % j_idx.n_docs, (7 * i + 1) % j_idx.n_docs]
                             for i in range(len(queries))]
    r_t = t_eng.query_batch(queries, top_k=10, **call)
    _assert_same(r_t, j_eng.query_batch(queries, top_k=10, **call))
    want = "compact" if kw["graph_impl"] == "compact" else "dense"
    assert r_t.diagnostics["graph_impl"] == want


def test_graph_form_rule_matches_jax():
    """`auto` takes the dense form while the [B, N] f32 buffers fit 256 MB
    and fusion is pool-compact (query_engine.py:573-576 of the JAX
    engine); the matmul dense channel needs the dense form."""
    n = 1000
    big = (256 << 20) // (4 * n) + 1
    for graph_impl, fusion_impl, B, compact in (
            ("auto", "compact", 8, False), ("auto", "compact", big, True),
            ("auto", "dense", big, False), ("dense", "compact", big, False),
            ("compact", "compact", 8, True)):
        cfg = TConfig(graph_impl=graph_impl, fusion_impl=fusion_impl)
        assert use_compact_graph(cfg, B, n) is compact
        cfg = TConfig(graph_impl=graph_impl, fusion_impl=fusion_impl,
                      dense_impl="matmul")
        if compact:
            with pytest.raises(ValueError, match="matmul"):
                use_compact_graph(cfg, B, n)
        else:
            assert use_compact_graph(cfg, B, n) is False


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
    """On the dense form the [B, N] product agrees with the pool gather;
    with the compact graph it raises, as in JAX, at dispatch."""
    _, t_idx, queries = tie_free
    kw = dict(_exact_kw(False), graph_impl="dense")
    pool = TorchQueryEngine(t_idx, device="cpu",
                            config=TConfig(**kw, dense_impl="pool"))
    mm = TorchQueryEngine(t_idx, device="cpu",
                          config=TConfig(**kw, dense_impl="matmul"))
    r_p, r_m = pool.query_batch(queries), mm.query_batch(queries)
    np.testing.assert_array_equal(r_m.hits.ids, r_p.hits.ids)
    np.testing.assert_allclose(r_m.hits.scores, r_p.hits.scores, atol=ATOL)
    compact = TorchQueryEngine(t_idx, device="cpu", config=TConfig(
        **dict(kw, graph_impl="compact"), dense_impl="matmul"))
    with pytest.raises(ValueError, match="matmul"):
        compact.query_batch(queries)
    with pytest.raises(ValueError, match="matmul"):
        compact.query_batch_async(queries)


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
    hits = eng.hydrate_hits(r, 0, extra_meta={"hop": 1,
                                              "score_text_norm": -1.0})
    assert 0 < len(hits) <= 5 and all(isinstance(h, Hit) for h in hits)
    assert hits[0].id.startswith("sent::") and hits[0].meta["hop"] == 1
    assert hits[0].score == float(r.hits.scores[0, 0])
    assert {"score_text_norm", "score_graph_norm",
            "score_dense_norm"} <= set(hits[0].meta)
    # the channel norms win key collisions with extra_meta
    assert hits[0].meta["score_text_norm"] == float(r.channel_norms[0, 0, 0])
    empty = eng.query_batch([])
    assert empty.hits.ids.shape == (0, 5)
    assert eng.query_dense_batch([]).hits.ids.shape[0] == 0
    assert eng.device_bytes() > 0


@pytest.mark.parametrize("fields,exc", [
    ({"sparse_impl": "splade"}, ValueError),  # needs splade_weights
    ({"sparse_impl": "splade", "splade_weights": "x.npz",
      "bm25_impl": "scatter"}, ValueError),
    ({"sparse_impl": "spalde"}, ValueError),
    ({"graph_impl": "compcat"}, ValueError),
    ({"dense_impl": "mamtul"}, ValueError),
    ({"bm25_impl": "scater"}, ValueError),
    ({"fusion_impl": "dens"}, ValueError),
    ({"graph_impl": "compact", "fusion_impl": "dense"}, ValueError),
])
def test_unported_or_unknown_formulations_raise(tie_free, fields, exc):
    """Every formulation is ported; typos, SPLADE without its weights or
    with the scatter BM25, and the compact graph with the dense fusion
    oracle are rejected at construction."""
    _, t_idx, _ = tie_free
    with pytest.raises(exc):
        TorchQueryEngine(t_idx, device="cpu", config=TConfig(**fields))


def test_trace_id_and_prepruned_surface(tie_free):
    """The surface the iterative driver calls: ``trace_id`` on both
    entry points, and pre-pruned hop-2 variants."""
    _, t_idx, queries = tie_free
    eng = TorchQueryEngine(t_idx, device="cpu",
                           config=TConfig(**_exact_kw(False)))
    assert eng._supports_prepruned is True
    r = eng.query_batch(queries, trace_id="t-1")
    pending = eng.query_batch_async(queries, trace_id="t-1-hop2",
                                    prepruned=True, pool_k=32)
    assert pending._trace_id == "t-1-hop2"
    r2 = pending.result()
    assert r2.diagnostics["pool"]["bm25_pool_k"] == 32
    np.testing.assert_array_equal(r.hits.ids[:, :3], r2.hits.ids[:, :3])


def test_engine_requires_explicit_device(tie_free):
    """Without ``device`` the engine is on the card: where CUDA is absent
    that raises, never falls back to the CPU. ``None`` is no device."""
    _, t_idx, _ = tie_free
    with pytest.raises(TypeError):
        TorchQueryEngine(t_idx, device=None)
    if torch.cuda.is_available():
        assert TorchQueryEngine(t_idx).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            TorchQueryEngine(t_idx)


def test_compare_topk_accepts_only_tie_swaps():
    ids = np.array([[5, 3, 9, 1]])
    s = np.array([[0.9, 0.5, 0.5, 0.1]], np.float32)
    assert compare_topk(ids, s, np.array([[5, 9, 3, 1]]), s, 1e-6)[1] == [0]
    with pytest.raises(AssertionError):
        compare_topk(ids, s, np.array([[3, 5, 9, 1]]), s, 1e-6)
    with pytest.raises(AssertionError):
        compare_topk(ids, s, ids, s + 1e-3, 1e-6)
