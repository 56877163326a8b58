"""The port's SPLADE retrieval ops and the engine's learned-sparse channel
against the JAX package on the CPU.

One small SPLADE checkpoint (2 layers, d 32, vocab 1024, L 16, float32
compute so both packages agree to summation order) is saved once by the
JAX package and loaded by both. Host structures (`SpladeDeviceIndex`,
`splade_engine_arrays`) must be array-equal; ranked ids identical on the
tie-free corpus; scores within ATOL (f32 sums taken in other orders over
<= 32 query terms of weight <= ~3 and impacts <= ~3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import compare_topk
from a_modular_rag_framework_torch.engine import EngineConfig as TConfig
from a_modular_rag_framework_torch.engine import TorchQueryEngine
from a_modular_rag_framework_torch.index import SentenceCorpus as TCorpus
from a_modular_rag_framework_torch.index import build_packed_index as t_build
from a_modular_rag_framework_torch.models import cross_encoder as t_cross
from a_modular_rag_framework_torch.models import splade as t_splade
from a_modular_rag_framework_torch.ops import splade as t_ops
from a_modular_rag_framework_tpu.engine.query_engine import (EngineConfig,
                                                             TPUQueryEngine)
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.models import cross_encoder as j_cross
from a_modular_rag_framework_tpu.models import encoder as j_enc
from a_modular_rag_framework_tpu.models import splade as j_splade
from a_modular_rag_framework_tpu.ops import splade as j_ops
from a_modular_rag_framework_tpu.parallel.sharded_hybrid import _tie_free_corpus

ATOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    corpus, queries = _tie_free_corpus()
    j_idx = build_packed_index(corpus, embed_dim=16, embed_dtype="float32")
    t_idx = t_build(TCorpus(docs=list(corpus.docs)), embed_dim=16,
                    embed_dtype="float32")
    cfg = j_splade.SpladeConfig(
        encoder=j_enc.EncoderConfig(vocab_size=1024, d_model=32, n_heads=2,
                                    n_layers=2, d_ff=64, max_len=16,
                                    subword_ngrams=4, dtype=jnp.float32),
        doc_top_terms=32, query_top_terms=8)
    j_encoder = j_splade.SpladeEncoder(cfg, seed=7)
    ckpt = str(tmp_path_factory.mktemp("splade") / "sp.npz")
    j_encoder.save(ckpt)
    t_encoder = t_splade.SpladeEncoder.load(ckpt, device="cpu")
    assert t_encoder.cfg.encoder.dtype == torch.float32
    j_r = j_ops.SpladeRetriever(j_encoder, term_topm=256, build_batch=64)
    t_r = t_ops.SpladeRetriever(t_encoder, term_topm=256, build_batch=64)
    j_r.build(corpus.texts())
    t_r.build(corpus.texts())
    return dict(corpus=corpus, queries=list(queries), j_idx=j_idx,
                t_idx=t_idx, ckpt=ckpt, j_enc=j_encoder, t_enc=t_encoder,
                j_r=j_r, t_r=t_r)


def test_device_index_from_expansions_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    N, K, V = 50, 12, 64
    term_ids = rng.integers(-1, V, size=(N, K)).astype(np.int32)
    # coarse weights: many equal impacts, so the (term, -impact, doc) order
    # and its tie rule are exercised; zeros must be dropped
    weights = (rng.integers(0, 5, size=(N, K)) / 4).astype(np.float32)
    j = j_ops.SpladeDeviceIndex.from_expansions(term_ids, weights, V)
    t = t_ops.SpladeDeviceIndex.from_expansions(term_ids, weights, V)
    for f in ("doc_ids", "impacts", "row_ptr"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.n_docs == j.n_docs == N
    # the .npz caches interchange
    t.save(str(tmp_path / "t.npz"))
    j.save(str(tmp_path / "j.npz"))
    for a, b in ((j_ops.SpladeDeviceIndex.load(str(tmp_path / "t.npz")), j),
                 (t_ops.SpladeDeviceIndex.load(str(tmp_path / "j.npz")), t)):
        for f in ("doc_ids", "impacts", "row_ptr"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.n_docs == N

    j_arr = j_ops.splade_engine_arrays(j, K)
    t_arr = t_ops.splade_engine_arrays(t, K, "cpu")
    assert t_arr.keys() == j_arr.keys() and "posting_packed" in t_arr
    for key in t_arr:
        a, b = t_arr[key].numpy(), np.asarray(j_arr[key])
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    # the f32 -> i32 bit view of the impacts round-trips exactly
    np.testing.assert_array_equal(
        t_arr["posting_packed"][:, 1].contiguous().view(torch.float32).numpy(),
        t.impacts)


def test_built_index_equals_jax(setup):
    """The corpus expansion (device batches, padded tail) gives the same
    postings: term sets equal, impacts within ATOL."""
    j, t = setup["j_r"].index, setup["t_r"].index
    np.testing.assert_array_equal(t.row_ptr, j.row_ptr)
    np.testing.assert_allclose(t.impacts, j.impacts, atol=ATOL, rtol=0)
    # within a term, postings order by impact; ties and near-ties may swap
    V = len(t.row_ptr) - 1
    for term in range(V):
        a, b = t.row_ptr[term], t.row_ptr[term + 1]
        assert set(t.doc_ids[a:b]) == set(j.doc_ids[a:b]), term


def test_retriever_matches_its_oracle_and_jax(setup):
    qs = setup["queries"]
    t_ids, t_s = setup["t_r"].query_batch(qs, top_k=5)
    j_ids, j_s = setup["j_r"].query_batch(qs, top_k=5)
    assert t_ids.dtype == np.int32 and t_ids.shape == (len(qs), 5)
    # exact windows (term_topm >= n_docs): the CSR program equals the
    # dense oracle's ranking
    oracle = setup["t_r"].score_dense_oracle(qs)
    np.testing.assert_allclose(oracle, setup["j_r"].score_dense_oracle(qs),
                               atol=ATOL, rtol=0)
    for row in range(len(qs)):
        order = np.lexsort((np.arange(oracle.shape[1]), -oracle[row]))[:5]
        keep = oracle[row][order] > 0
        np.testing.assert_array_equal(t_ids[row][keep], order[keep])
        np.testing.assert_allclose(t_s[row][keep], oracle[row][order][keep],
                                   atol=ATOL, rtol=0)
        assert (t_ids[row][~keep] == -1).all()
    compare_topk(t_ids, t_s, j_ids, j_s, ATOL)
    np.testing.assert_array_equal(t_ids, j_ids)
    with pytest.raises(RuntimeError, match="build"):
        t_ops.SpladeRetriever(setup["t_enc"]).query_batch(qs)


@pytest.mark.parametrize("rerank", [False, True], ids=["plain", "reranked"])
def test_splade_dense_hybrid_matches_jax(setup, rerank, tmp_path):
    j_kw, t_kw = {}, {}
    if rerank:
        ccfg = dict(vocab_size=1024, d_model=32, n_heads=2, n_layers=1,
                    d_ff=64, max_len=24, max_query_len=8, subword_ngrams=4)
        j_rr = j_cross.CrossEncoderReranker(j_cross.CrossEncoderConfig(
            dtype=jnp.float32, **ccfg), seed=3, pair_budget=16)
        j_rr.save(str(tmp_path / "ce.npz"))
        t_rr = t_cross.CrossEncoderReranker.load(
            str(tmp_path / "ce.npz"), t_cross.CrossEncoderConfig(
                dtype=torch.float32, **ccfg), pair_budget=16, device="cpu")
        j_kw, t_kw = ({"reranker": j_rr, "rerank_top_m": 4},
                      {"reranker": t_rr, "rerank_top_m": 4})
    kw = dict(pool_k=20, term_topm=256, build_batch=64)
    j_h = j_ops.SpladeDenseHybrid(setup["j_enc"], **kw, **j_kw)
    t_h = t_ops.SpladeDenseHybrid(setup["t_enc"], **kw, **t_kw)
    texts = setup["corpus"].texts()
    j_h.build(texts)
    t_h.build(texts)
    np.testing.assert_allclose(t_h._emb.numpy(), np.asarray(j_h._emb),
                               atol=ATOL, rtol=0)
    qs = setup["queries"]
    j_ids, j_s = j_h.query_batch(qs, top_k=6)
    t_ids, t_s = t_h.query_batch(qs, top_k=6)
    assert t_ids.shape == (len(qs), 6)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_s, j_s, atol=ATOL, rtol=0)
    if rerank:  # the rerank stage reordered at least one row's head
        t_h.reranker = None
        plain_ids, _ = t_h.query_batch(qs, top_k=6)
        assert (plain_ids[:, :4] != t_ids[:, :4]).any()
        np.testing.assert_array_equal(np.sort(plain_ids[:, :4], axis=1),
                                      np.sort(t_ids[:, :4], axis=1))
        np.testing.assert_array_equal(plain_ids[:, 4:], t_ids[:, 4:])


# the cases of tests/test_splade_engine_channel.py, both engines side by side


def _engines(setup, **kw):
    cfg = dict(sparse_impl="splade", splade_weights=setup["ckpt"], top_k=5,
               batch_buckets=(8,), graph_pool_exact=True,
               graph_wave_dtype="float32", **kw)
    return (TorchQueryEngine(setup["t_idx"], device="cpu",
                             config=TConfig(**cfg)),
            TPUQueryEngine(setup["j_idx"], config=EngineConfig(**cfg)))


def _assert_same(r_t, r_j):
    compare_topk(r_t.hits.ids, r_t.hits.scores, np.asarray(r_j.hits.ids),
                 np.asarray(r_j.hits.scores), ATOL)
    np.testing.assert_array_equal(r_t.hits.ids, np.asarray(r_j.hits.ids))
    np.testing.assert_allclose(r_t.channel_norms,
                               np.asarray(r_j.channel_norms), atol=ATOL)
    for key in ("bm25_candidates", "graph_candidates", "dense_scored"):
        assert r_t.diagnostics[key] == r_j.diagnostics[key], key


def test_engine_splade_channel_matches_retriever_and_jax(setup):
    """Graph and dense alphas zeroed, exact windows: the engine's text
    channel ranks exactly like the standalone retriever."""
    t_eng, j_eng = _engines(setup, pool_k=64, alpha_text=1.0,
                            alpha_graph=0.0, alpha_dense=0.0,
                            graph_window=1, bm25_term_topm=256)
    qs = setup["queries"][:8]
    ids_ref, scores_ref = setup["t_r"].query_batch(qs, top_k=5)
    res = t_eng.query_batch(qs)
    for row in range(len(qs)):
        ref = [int(i) for i, s in zip(ids_ref[row], scores_ref[row])
               if i >= 0 and s > 0]
        assert [int(i) for i in res.hits.ids[row][:len(ref)]] == ref, row
    _assert_same(res, j_eng.query_batch(qs))
    # the engine built its own index: the retriever's, array for array
    for f in ("doc_ids", "impacts", "row_ptr"):
        np.testing.assert_array_equal(getattr(t_eng._splade_index, f),
                                      getattr(setup["t_r"].index, f))
    assert t_eng._high_df_terms is None


@pytest.mark.parametrize("form", ["compact", "dense"])
def test_engine_splade_full_hybrid_matches_jax(setup, form):
    t_eng, j_eng = _engines(setup, pool_k=32, graph_window=2,
                            bm25_term_topm=64, graph_impl=form)
    qs = setup["queries"][:8]
    r1 = t_eng.query_batch(qs)
    assert r1.hits.ids.shape == (8, 5)
    assert r1.diagnostics["graph_impl"] == form
    _assert_same(r1, j_eng.query_batch(qs))
    np.testing.assert_array_equal(r1.hits.ids, t_eng.query_batch(qs).hits.ids)
    # variant expansion rides the same path (E > 1), explicit seeds too
    ex = [[q.split(" ", 1)[-1]] for q in qs]
    _assert_same(t_eng.query_batch(qs, expansions=ex),
                 j_eng.query_batch(qs, expansions=ex))
    seeds = [[i, (5 * i + 2) % setup["t_idx"].n_docs] for i in range(len(qs))]
    _assert_same(t_eng.query_batch(qs, seed_rows=seeds, top_k=3),
                 j_eng.query_batch(qs, seed_rows=seeds, top_k=3))
    # a cached index passed back in, and the re-upload after a swap
    again = TorchQueryEngine(setup["t_idx"], device="cpu", config=t_eng.config,
                             splade_index=t_eng._splade_index)
    np.testing.assert_array_equal(again.query_batch(qs).hits.ids, r1.hits.ids)
    again.reload()
    np.testing.assert_array_equal(again.query_batch(qs).hits.ids, r1.hits.ids)
    pipelined = list(t_eng.query_batches_pipelined([qs[:4], qs[4:]]))
    t_eng.close()
    np.testing.assert_array_equal(
        np.concatenate([r.hits.ids for r in pipelined]), r1.hits.ids)


def test_engine_with_committed_bf16_checkpoint_matches_jax():
    """data/splade_variety.npz (bf16 compute) through both engines' text
    channel on a collide corpus: recall@10 and MRR equal, top-10 id sets
    overlapping >= 0.95 on average, min-max normalized scores within 5e-2
    (a bf16 rounding flip in a query weight, or a swapped low-weight term
    at the head's top-32 cut, moves a normalized score by ~1e-2)."""
    from a_modular_rag_framework_tpu.core.dataset_loader import \
        SyntheticHotpotQALoader
    from a_modular_rag_framework_tpu.eval.harness import evaluate_retrieval
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus

    samples = SyntheticHotpotQALoader(
        {"count": 32, "seed": 0, "n_distractors": 8,
         "collide_entities": True}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    j_idx = build_packed_index(corpus, embed_dim=16)
    t_idx = t_build(TCorpus(docs=list(corpus.docs)), embed_dim=16)
    cfg = dict(sparse_impl="splade", splade_weights="data/splade_variety.npz",
               top_k=10, pool_k=100, bm25_term_topm=128, batch_buckets=(32,),
               alpha_text=1.0, alpha_graph=0.0, alpha_dense=0.0,
               graph_pool_exact=True)
    j_eng = TPUQueryEngine(j_idx, config=EngineConfig(**cfg))
    t_eng = TorchQueryEngine(t_idx, device="cpu", config=TConfig(**cfg))
    j_q = evaluate_retrieval(j_eng, samples, k=10, batch_size=32)
    t_q = evaluate_retrieval(t_eng, samples, k=10, batch_size=32)
    assert t_q["recall_at_10"] == j_q["recall_at_10"] > 0.3
    assert abs(t_q["mrr"] - j_q["mrr"]) < 0.02
    qs = [s["question"] for s in samples]
    r_j, r_t = j_eng.query_batch(qs), t_eng.query_batch(qs)
    j_ids = np.asarray(r_j.hits.ids)
    overlap = np.mean([len(set(a) & set(b)) / 10
                       for a, b in zip(r_t.hits.ids, j_ids)])
    assert overlap >= 0.95, overlap
    np.testing.assert_allclose(np.sort(r_t.hits.scores, axis=1),
                               np.sort(np.asarray(r_j.hits.scores), axis=1),
                               atol=5e-2, rtol=0)


def test_engine_splade_config_validation(setup):
    t_idx, ckpt = setup["t_idx"], setup["ckpt"]
    with pytest.raises(ValueError, match="splade_weights"):
        TorchQueryEngine(t_idx, device="cpu",
                         config=TConfig(sparse_impl="splade"))
    with pytest.raises(ValueError, match="sorted"):
        TorchQueryEngine(t_idx, device="cpu", config=TConfig(
            sparse_impl="splade", splade_weights=ckpt, bm25_impl="scatter"))
    with pytest.raises(ValueError, match="sparse_impl"):
        TorchQueryEngine(t_idx, device="cpu",
                         config=TConfig(sparse_impl="typo"))


def test_rescore_pool_term_weights_oracle():
    """bm25_rescore_pool's term_weights seam == numpy weighted sum."""
    from a_modular_rag_framework_torch.ops.bm25 import bm25_rescore_pool

    rng = np.random.default_rng(0)
    N, D, B, E, T, K = 20, 6, 3, 2, 4, 5
    doc_terms = rng.integers(0, 30, size=(N, D)).astype(np.int32)
    doc_terms[:, -2:] = -2  # padding
    doc_scores = rng.random((N, D)).astype(np.float32)
    doc_scores[doc_terms == -2] = 0.0
    term_ids = rng.integers(-1, 30, size=(B, E, T)).astype(np.int32)
    weights = rng.random((B, E, T)).astype(np.float32)
    pool_i = rng.integers(-1, N, size=(B, K)).astype(np.int32)
    got = bm25_rescore_pool(
        torch.from_numpy(pool_i), torch.from_numpy(term_ids),
        torch.from_numpy(doc_terms), torch.from_numpy(doc_scores), n_docs=N,
        term_weights=torch.from_numpy(weights)).numpy()
    want = np.zeros((B, K), dtype=np.float32)
    for b in range(B):
        for ki in range(K):
            d = pool_i[b, ki]
            if d < 0:
                continue
            want[b, ki] = max(
                sum(weights[b, e, t] * float(
                    doc_scores[d][doc_terms[d] == term_ids[b, e, t]].sum())
                    for t in range(T) if term_ids[b, e, t] >= 0)
                for e in range(E))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
