"""Iterative bridge-entity 2-hop retrieval: the port vs the JAX package.

A tie-free bridge corpus (random lowercase words, capitalized two-word
titles; each document's first sentence names its partner's title) gives
every question a bridge. Engines over the same corpus, with an exact
graph pool and f32 waves on the JAX side and idf pruning on (so the
native bridge emits pre-pruned hop-2 variants): ids and hop-2 queries must
be identical, scores within atol 1e-5. Each iterative case runs with the
native C++ bridge and with the Python path; where the native library did
not load, both cases take the Python path and must still agree.
"""
import random
import weakref

import numpy as np
import pytest

from a_modular_rag_framework_torch.engine import EngineConfig as TConfig
from a_modular_rag_framework_torch.engine import QueryResult as TResult
from a_modular_rag_framework_torch.engine import TorchQueryEngine
from a_modular_rag_framework_torch.index import SentenceCorpus as TCorpus
from a_modular_rag_framework_torch.index import build_packed_index as t_build
from a_modular_rag_framework_torch.modules.retrieval import multihop as tmh
from a_modular_rag_framework_tpu.engine.query_engine import (EngineConfig,
                                                             TPUQueryEngine)
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
from a_modular_rag_framework_tpu.modules.retrieval import multihop as jmh

ATOL = 1e-5
FIRST = ["Arlo", "Bexley", "Corin", "Dalia", "Emrys", "Fenna", "Galen",
         "Hollis", "Ilse", "Jorah", "Kestrel", "Lumen", "Maren", "Nyles",
         "Orrin", "Petra", "Quill", "Rowan", "Soren", "Tamsin", "Ulric",
         "Vesna", "Wilder", "Xanthe"]
LAST = ["Ashdown", "Brightwater", "Coldfell", "Dunmore", "Everhart",
        "Foxley", "Greyhaven", "Holloway", "Ironwood", "Juniper", "Kingsley",
        "Larkspur", "Marlowe", "Northcott", "Oakhurst", "Pembrook", "Quenby",
        "Ravenscar", "Stonebridge", "Thornfield", "Underhill", "Valemont",
        "Westbrook", "Yarrow"]


def _bridge_corpus(seed=3):
    """(docs, questions): 24 entities; "met" is the one frequent word
    (pruned at query_df_ratio_max 0.25)."""
    rng = random.Random(seed)
    words = [f"w{chr(97 + i % 26)}{i}" for i in range(240)]
    names = [f"{f} {LAST[(i * 7) % len(LAST)]}" for i, f in enumerate(FIRST)]
    partner = list(range(len(names)))
    rng.shuffle(partner)

    def rw(lo, hi):
        return " ".join(rng.choice(words) for _ in range(rng.randrange(lo, hi)))

    docs, questions = [], []
    for e, name in enumerate(names):
        p = partner[e] if partner[e] != e else (e + 1) % len(names)
        sents = ([f"{name} {rw(2, 6)} met {names[p]} {rw(1, 5)}"]
                 + [rw(4, 12) for _ in range(rng.randrange(1, 4))])
        for si, text in enumerate(sents):
            docs.append({"doc_id": f"{name}#{si}", "title": name,
                         "sent_id": si, "text": text})
        questions.append(f"{rw(2, 4)} met {name} {rw(1, 3)}")
    return docs, questions


CFG = dict(top_k=20, pool_k=64, graph_window=2, bm25_term_topm=4096,
           batch_buckets=(8, 32), graph_pool_exact=True,
           graph_wave_dtype="float32", graph_compact_cap=64,
           query_df_ratio_max=0.25, hop2_graph_window=0, hop2_pool_k=32)


@pytest.fixture(scope="module")
def corpora():
    docs, questions = _bridge_corpus()
    j_idx = build_packed_index(SentenceCorpus(docs=docs), embed_dim=32,
                               embed_dtype="float32")
    t_idx = t_build(TCorpus(docs=list(docs)), embed_dim=32,
                    embed_dtype="float32")
    return j_idx, t_idx, questions


@pytest.fixture(params=["native", "python"])
def bridge(request, corpora):
    """Route both packages' bridge stage: "python" gates the native bridge
    off for both indexes; "native" starts from an empty cache (the native
    bridge is used when its library loaded)."""
    j_idx, t_idx, _ = corpora
    saved = jmh._NATIVE_BRIDGES, tmh._NATIVE_BRIDGES
    jmh._NATIVE_BRIDGES = weakref.WeakKeyDictionary()
    tmh._NATIVE_BRIDGES = weakref.WeakKeyDictionary()
    if request.param == "python":
        for idx in (j_idx, t_idx):  # either driver over either engine
            jmh._NATIVE_BRIDGES[idx] = None
            tmh._NATIVE_BRIDGES[idx] = None
    try:
        yield request.param
    finally:
        jmh._NATIVE_BRIDGES, tmh._NATIVE_BRIDGES = saved


def _engines(corpora, **over):
    j_idx, t_idx, questions = corpora
    kw = dict(CFG, **over)
    return (TPUQueryEngine(j_idx, config=EngineConfig(**kw)),
            TorchQueryEngine(t_idx, device="cpu", config=TConfig(**kw)),
            questions)


def _assert_same_iterative(got, want):
    ids, scores, norms, diag = got
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_allclose(scores, want[1], atol=ATOL)
    np.testing.assert_allclose(norms, want[2], atol=ATOL)
    assert diag["hop2_active"] == want[3]["hop2_active"]
    assert diag["hop2_queries"] == want[3]["hop2_queries"]


@pytest.mark.parametrize("graph_impl", ["auto", "compact"])
def test_iterative_matches_jax(corpora, bridge, graph_impl):
    j_eng, t_eng, qs = _engines(corpora, graph_impl=graph_impl)
    want = jmh.iterative_retrieve(j_eng, qs, top_k=10)
    got = tmh.iterative_retrieve(t_eng, qs, top_k=10)
    _assert_same_iterative(got, want)
    assert got[3]["hop2_active"] == len(qs)
    assert got[0].shape == (len(qs), 10) and got[2].shape == (len(qs), 3, 10)
    if bridge == "native" and tmh._NATIVE_BRIDGES.get(corpora[1]) is not None:
        # pre-pruned variants: lowercased, "met" dropped, phrase token kept
        assert all("met" not in q.split() and "00" in q
                   for q in got[3]["hop2_queries"])
    # the JAX driver over the port's engine is the port's driver
    _assert_same_iterative(jmh.iterative_retrieve(t_eng, qs, top_k=10), got)


def test_iterative_beats_single_pass(corpora, bridge):
    """The hop-2 target of each question is the partner's first sentence,
    which the question does not name: single-pass reaches few of them
    (through the entity graph), the bridge nearly all."""
    _, t_eng, qs = _engines(corpora)
    corpus = t_eng.index.corpus
    docs = corpus.docs
    want = []
    for q, d in zip(qs, (d for d in docs if d["sent_id"] == 0)):
        partner = d["text"].split(" met ")[1].split(" w")[0]
        want.append(next(i for i, x in enumerate(docs)
                         if x["title"] == partner and x["sent_id"] == 0))
    single = t_eng.query_batch(qs, top_k=10).hits.ids
    ids, *_ = tmh.iterative_retrieve(t_eng, qs, top_k=10)
    hit1 = sum(w in row for w, row in zip(want, single.tolist()))
    hit2 = sum(w in row for w, row in zip(want, ids.tolist()))
    assert hit2 > hit1 and hit2 >= len(qs) - 2


def test_iterative_pipelined_matches_jax_and_sequential(corpora, bridge):
    j_eng, t_eng, qs = _engines(corpora)
    batches = [qs[:8], list(reversed(qs))[:8], qs[8:16]]
    try:
        got = list(tmh.iterative_retrieve_pipelined(t_eng, batches, top_k=10))
        want = list(jmh.iterative_retrieve_pipelined(j_eng, batches,
                                                     top_k=10))
    finally:
        t_eng._mh_prep_pool.shutdown(wait=True)
        j_eng._mh_prep_pool.shutdown(wait=True)
    assert len(got) == len(batches)
    for batch, g, w in zip(batches, got, want):
        _assert_same_iterative(g, w)
        _assert_same_iterative(g, tmh.iterative_retrieve(t_eng, batch,
                                                         top_k=10))


def test_iterative_pending_and_hop2_knobs_reach_dispatch(corpora):
    """IterativePending returns the port's QueryResult equal to the direct
    call; hop-2 dispatches with hop2_graph_window, hop2_pool_k (as
    ``pool_k``), a ``-hop2`` trace id and pre-pruned variants."""
    _, t_eng, qs = _engines(corpora)
    seen = []
    orig = t_eng.query_batch_async

    def spy(queries, **kw):
        seen.append(kw)
        return orig(queries, **kw)

    t_eng.query_batch_async = spy
    try:
        p = tmh.IterativePending(
            t_eng, qs[:8], t_eng.query_batch_async(qs[:8], top_k=20,
                                                   trace_id="req"),
            top_k=10, trace_id="req")
        res = p.result()
    finally:
        del t_eng.query_batch_async
    assert isinstance(res, TResult)
    ids, scores, norms, _ = tmh.iterative_retrieve(t_eng, qs[:8], top_k=10)
    np.testing.assert_array_equal(res.hits.ids, ids)
    np.testing.assert_allclose(res.hits.scores, scores, atol=0)
    np.testing.assert_allclose(res.channel_norms, np.moveaxis(norms, 1, 0),
                               atol=0)
    hop2 = seen[1]
    assert hop2["graph_window"] == 0 and hop2["pool_k"] == 32
    assert hop2["trace_id"] == "req-hop2"
    native = tmh._NATIVE_BRIDGES.get(t_eng.index) is not None
    assert hop2.get("prepruned", False) is native


def _fake_r2(ids2, scores2, norms2):
    return TResult(hits=tmh.HitBatch(ids=ids2, scores=scores2),
                   channel_norms=norms2)


def test_merge_hop2_matches_both_jax_merges():
    """The port's vectorized merge vs JAX's vectorized merge and its loop
    oracle, on random inputs with exact score ties, reserve settings,
    inactive rows, -1 padding and hop-1/hop-2 overlap."""
    rng = np.random.default_rng(7)
    B, K1, K2 = 24, 20, 10
    for trial in range(4):
        for reserve in (None, 0, 3, 8):
            ids1 = np.stack([rng.choice(500, K1, replace=False)
                             for _ in range(B)]).astype(np.int32)
            ids2 = np.stack([np.concatenate(
                [rng.choice(ids1[b], K2 // 2, replace=False),
                 rng.choice(np.arange(500, 600), K2 - K2 // 2,
                            replace=False)]) for b in range(B)]
            ).astype(np.int32)
            ids1[0, :5] = -1
            ids2[1, :4] = -1
            s1 = np.sort(rng.random((B, K1)).astype(np.float32) + 0.5,
                         axis=1)[:, ::-1]
            s2 = np.sort(rng.random((B, K2)).astype(np.float32) + 0.8,
                         axis=1)[:, ::-1]
            if trial >= 2:  # exact ties across different ids
                s1, s2 = np.round(s1 * 4) / 4, np.round(s2 * 4) / 4
            ctx = {"ids1": ids1, "scores1": s1,
                   "norms1": rng.random((3, B, K1)).astype(np.float32),
                   "active": [bool(rng.random() > 0.2) for _ in range(B)],
                   "diagnostics": {"d": 1}}
            r2 = _fake_r2(ids2, s2, rng.random((3, B, K2)).astype(np.float32))
            kw = dict(top_k=10, hop_decay=0.5, hop2_reserve=reserve)
            got = tmh._merge_hop2(["q"] * B, dict(ctx), r2, **kw)
            for ref in (jmh._merge_hop2, jmh._merge_hop2_py,
                        tmh._merge_hop2_py):
                want = ref(["q"] * B, dict(ctx), r2, **kw)
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_allclose(got[1], want[1], atol=1e-6)
                np.testing.assert_allclose(got[2], want[2], atol=1e-6)
                assert got[3] == want[3]
    # hit widths narrower than top_k (tiny corpora) pad to top_k
    ctx = {"ids1": np.array([[0, 1, 2, 3], [3, 2, -1, -1]], np.int32),
           "scores1": np.array([[.9, .8, .7, .6], [.9, .8, 0, 0]], np.float32),
           "norms1": np.zeros((3, 2, 4), np.float32),
           "active": [True, True], "diagnostics": {}}
    r2 = _fake_r2(np.array([[2, 5, -1, -1], [0, 1, 5, -1]], np.int32),
                  np.array([[.9, .5, 0, 0], [.7, .6, .5, 0]], np.float32),
                  np.ones((3, 2, 4), np.float32))
    got = tmh._merge_hop2(["a", "b"], dict(ctx), r2, top_k=10,
                          hop_decay=0.5, hop2_reserve=None)
    want = jmh._merge_hop2_py(["a", "b"], dict(ctx), r2, top_k=10,
                              hop_decay=0.5, hop2_reserve=None)
    assert got[0].shape == (2, 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)


@pytest.mark.parametrize("case", range(4))
def test_bridge_helpers_match_jax(case):
    """doc_bridge_runs / bridge_entities / hop2_queries_for on synthetic
    hit texts: question words, non-title spans, substrings of question
    entities, titles anchoring a hop-1 sentence, and non-ASCII names."""
    q = ["In which city was the collaborator of Alice Smith born?",
         "Who directed the film Psycho?",
         "Where did Ana María Ortiz study?",
         "What did Bob Jones write?"][case]
    texts = ["Bob Jones was born in Rome.",
             "Alice Smith collaborated closely with Bob Jones.",
             "Later in life Alice Smith retired in Rome.",
             "The black-and-white horror classic was directed by Alfred "
             "Hitchcock.",
             "Ana María Ortiz studied with José Čapek in Praha.",
             "Smith and Jones wrote The Long Road together."]
    titles = ["Bob Jones", "Alice Smith", "Alice Smith", "Psycho",
              "Ana María Ortiz", "The Long Road"]
    known = {"Alice Smith", "Bob Jones", "Rome", "Alfred Hitchcock",
             "José Čapek", "Praha", "The Long Road", "Smith"}
    for t in texts:
        assert tmh.doc_bridge_runs(t, known) == jmh.doc_bridge_runs(t, known)
        assert tmh.doc_bridge_runs(t, None) == jmh.doc_bridge_runs(t, None)
    for kw in (dict(known_titles=known), dict(known_titles=known,
                                              hit_titles=titles),
               dict(known_titles=None, max_entities=2)):
        b_t = tmh.bridge_entities(q, texts, **kw)
        assert b_t == jmh.bridge_entities(q, texts, **kw)
        for mv in (1, 3):
            assert (tmh.hop2_queries_for(q, b_t, max_variants=mv)
                    == jmh.hop2_queries_for(q, b_t, max_variants=mv))
    if case == 0:
        assert tmh.bridge_entities(q, texts, known_titles=known)[0] == \
            "Bob Jones"
