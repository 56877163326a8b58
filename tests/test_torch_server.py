"""QueryServer of the port: the cases of tests/test_serving_and_graph_store.py
(concurrent singles, iterative mode, grouping by parameters, submit_many,
oversized units, threaded clients, stop with queued requests, and mixed
modes beside a pipelined iterative loop) on TorchQueryEngine. Every
served result must equal the direct call on the same engine."""
import concurrent.futures
from collections.abc import Sequence
from concurrent.futures import CancelledError

import numpy as np
import pytest

from a_modular_rag_framework_torch.core.dto import Hit
from a_modular_rag_framework_torch.engine import EngineConfig, TorchQueryEngine
from a_modular_rag_framework_torch.engine.server import QueryServer
from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                 build_packed_index)
from a_modular_rag_framework_torch.modules.retrieval.multihop import (
    iterative_retrieve, iterative_retrieve_pipelined)
from a_modular_rag_framework_tpu.core.dataset_loader import \
    SyntheticHotpotQALoader


@pytest.fixture(scope="module")
def engine():
    samples = SyntheticHotpotQALoader({"count": 12, "seed": 9}).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=32, embed_dtype="float32")
    eng = TorchQueryEngine(idx, device="cpu", config=EngineConfig(
        top_k=5, pool_k=50, batch_buckets=(8, 32)))
    yield eng, samples
    eng.close()
    pool = getattr(eng, "_mh_prep_pool", None)
    if pool is not None:
        pool.shutdown(wait=True)


def _ids(eng, row_ids):
    return [eng.index.corpus.hit_id(int(i)) for i in row_ids if i >= 0]


def test_server_batches_concurrent_queries(engine):
    eng, samples = engine
    server = QueryServer(eng, max_batch=16, max_wait_ms=20)
    with server:
        futures = [server.submit(s["question"]) for s in samples]
        results = [f.result(timeout=60) for f in futures]
    # a lazy Sequence[Hit] view: Hits are built on first access
    assert all(isinstance(r, Sequence) and len(r) for r in results)
    assert all(h.id.startswith("sent::") for h in results[0])
    assert isinstance(results[0][0], Hit) and list(results[0])
    assert server.stats["queries"] == len(samples)
    assert max(server.stats["batch_sizes"]) > 1
    direct = eng.query_batch([s["question"] for s in samples]).hits.ids
    for row, hits in enumerate(results):
        assert [h.id for h in hits] == _ids(eng, direct[row])


def test_server_iterative_mode_matches_direct(engine):
    eng, samples = engine
    qs = [s["question"] for s in samples[:6]]
    direct_ids, direct_scores, _, _ = iterative_retrieve(eng, qs, top_k=5)
    with QueryServer(eng, max_batch=8, max_wait_ms=30) as server:
        futures = [server.submit(q, mode="iterative", top_k=5) for q in qs]
        results = [f.result(timeout=60) for f in futures]
    for row, hits in enumerate(results):
        assert [h.id for h in hits] == _ids(eng, direct_ids[row]), row
        np.testing.assert_allclose([h.score for h in hits],
                                   direct_scores[row][:len(hits)], atol=0)


def test_server_mixed_params_grouped(engine):
    eng, samples = engine
    with QueryServer(eng, max_batch=8, max_wait_ms=20) as server:
        f1 = server.submit(samples[0]["question"], top_k=3)
        f2 = server.submit(samples[1]["question"], top_k=5)
        r1, r2 = f1.result(60), f2.result(60)
    assert len(r1) <= 3 and len(r2) <= 5


def test_server_submit_many_matches_singular(engine):
    eng, samples = engine
    qs = [s["question"] for s in samples[:6]]
    with QueryServer(eng, max_batch=16, max_wait_ms=20) as server:
        singles = [server.submit(q) for q in qs]
        single_hits = [f.result(timeout=60) for f in singles]
        many = server.submit_many(qs).result(timeout=60)
    assert len(many) == len(qs)
    for got, want in zip(many, single_hits):
        assert [h.id for h in got] == [h.id for h in want]
        assert got == want  # LazyHits compare as Hit lists


def test_server_submit_many_mixed_with_singles(engine):
    eng, samples = engine
    qs = [s["question"] for s in samples[:4]]
    with QueryServer(eng, max_batch=32, max_wait_ms=30) as server:
        fm = server.submit_many(qs[:3])
        fs = server.submit(qs[3])
        many, single = fm.result(60), fs.result(60)
    assert len(many) == 3 and all(m for m in many)
    assert single and single[0].id.startswith("sent::")
    assert max(server.stats["batch_sizes"]) >= 4


def test_server_submit_many_oversized_unit(engine):
    eng, samples = engine
    qs = [s["question"] for s in samples] * 2  # 24 > max_batch=8
    with QueryServer(eng, max_batch=8, max_wait_ms=10) as server:
        out = server.submit_many(qs).result(timeout=60)
    assert len(out) == len(qs) and all(out)


def test_server_submit_many_iterative_and_empty(engine):
    eng, samples = engine
    qs = [s["question"] for s in samples[:3]]
    direct_ids, _, _, _ = iterative_retrieve(eng, qs, top_k=5)
    with QueryServer(eng, max_batch=8, max_wait_ms=10) as server:
        out = server.submit_many(qs, mode="iterative", top_k=5).result(60)
        assert server.submit_many([]).result(1) == []
        with pytest.raises(ValueError):
            server.submit(qs[0], mode="triple")
    for row, hits in enumerate(out):
        assert [h.id for h in hits] == _ids(eng, direct_ids[row])


def test_server_threaded_clients(engine):
    eng, samples = engine
    with QueryServer(eng, max_batch=8, max_wait_ms=10) as server:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(lambda s: server.query(s["question"]),
                                 samples[:8]))
    assert all(outs)


def test_server_stop_rejects_undispatched(engine):
    """Requests still queued at stop() fail fast instead of hanging."""
    eng, _ = engine
    server = QueryServer(eng, max_batch=4)
    fut = server.submit("orphaned question")  # never started
    server.stop()
    with pytest.raises(CancelledError):
        fut.result(timeout=1)


def test_server_concurrent_mixed_modes_with_batch_loop(engine):
    """Server threads answering single AND iterative submits while a
    pipelined iterative loop runs on the same engine (shared native
    bridge, doc-run cache and prep pools): every result equals its
    direct-call oracle."""
    eng, samples = engine
    qs = [s["question"] for s in samples[:8]]
    want_iter, _, _, _ = iterative_retrieve(eng, qs, top_k=5)
    want_single = eng.query_batch(qs, top_k=5).hits.ids
    want_batches = [r[0] for r in iterative_retrieve_pipelined(
        eng, [qs, list(reversed(qs))] * 2, top_k=5)]

    def batch_loop():
        return [r[0] for r in iterative_retrieve_pipelined(
            eng, [qs, list(reversed(qs))] * 2, top_k=5)]

    with QueryServer(eng, max_batch=8, max_wait_ms=10) as server:
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            fut_loop = pool.submit(batch_loop)
            fut_it = [server.submit(q, mode="iterative", top_k=5)
                      for q in qs]
            fut_sg = [server.submit(q, top_k=5) for q in qs]
            got_loop = fut_loop.result(timeout=120)
            got_it = [f.result(timeout=120) for f in fut_it]
            got_sg = [f.result(timeout=120) for f in fut_sg]

    for got, want in zip(got_loop, want_batches):
        np.testing.assert_array_equal(got, want)
    for row, hits in enumerate(got_it):
        assert [h.id for h in hits] == _ids(eng, want_iter[row]), row
    for row, hits in enumerate(got_sg):
        assert [h.id for h in hits] == _ids(eng, want_single[row]), row
