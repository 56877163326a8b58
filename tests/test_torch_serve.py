"""The port's HTTP serving front (`cli/serve.py`): routes, batching, error
paths, on the CPU, as `tests/test_serve_cli.py` holds the JAX package's,
and `_App.handle` of both packages on one packed index.

The comparison corpus is tie-free (unique entities, one distractor, under
64 rows: every BM25 cut is vacuous) and both engines use float32 waves and
an exact graph pool, so ids are identical and scores agree within ATOL =
1e-5 (summation order). Without ``--device`` the CLI's engine asks for the
card and raises on a host without one.
"""
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from a_modular_rag_framework_torch import system as t_system
from a_modular_rag_framework_torch.cli import serve as t_serve
from a_modular_rag_framework_torch.cli.ingest_hotpotqa import ingest as t_ingest
from a_modular_rag_framework_torch.core.dataset_loader import (
    SyntheticHotpotQALoader)
from a_modular_rag_framework_torch.engine import EngineConfig, TorchQueryEngine
from a_modular_rag_framework_torch.engine.server import QueryServer
from a_modular_rag_framework_torch.index import (PackedIndex, SentenceCorpus,
                                                 build_packed_index)
from a_modular_rag_framework_tpu.cli import serve as j_serve
from a_modular_rag_framework_tpu.engine.query_engine import (
    EngineConfig as JEngineConfig)
from a_modular_rag_framework_tpu.engine.query_engine import TPUQueryEngine
from a_modular_rag_framework_tpu.engine.server import (
    QueryServer as JQueryServer)
from a_modular_rag_framework_tpu.index.packed import PackedIndex as JPackedIndex

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
PARITY_CFG = dict(top_k=5, pool_k=50, batch_buckets=(8, 32),
                  graph_wave_dtype="float32", graph_pool_exact=True)


@pytest.fixture(scope="module")
def http_app():
    samples = SyntheticHotpotQALoader({"count": 12, "seed": 5}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    eng = TorchQueryEngine(idx, device="cpu", config=EngineConfig(
        top_k=5, pool_k=50, batch_buckets=(8, 32)))
    with QueryServer(eng, max_batch=16, max_wait_ms=5.0) as qserver:
        app = t_serve._App(qserver, idx.n_docs, qa=False)
        httpd = t_serve.make_server("127.0.0.1", 0, app)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            yield f"http://127.0.0.1:{httpd.server_address[1]}", samples
        finally:
            httpd.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(http_app):
    base, _ = http_app
    code, out = _get(base + "/healthz")
    assert code == 200 and out["ok"] and out["corpus"] > 0


def test_query_roundtrip(http_app):
    base, samples = http_app
    code, out = _post(base + "/query",
                      {"query": samples[0]["question"], "top_k": 3})
    assert code == 200
    assert out["hits"] and len(out["hits"]) <= 3
    assert out["hits"][0]["id"].startswith("sent::")
    assert isinstance(out["hits"][0]["score"], float)


def test_query_batch_matches_singles(http_app):
    base, samples = http_app
    qs = [s["question"] for s in samples[:4]]
    _, batch = _post(base + "/query_batch", {"queries": qs})
    singles = [_post(base + "/query", {"query": q})[1]["hits"] for q in qs]
    assert len(batch["results"]) == 4
    for got, want in zip(batch["results"], singles):
        assert [h["id"] for h in got] == [h["id"] for h in want]


def test_concurrent_http_clients_microbatch(http_app):
    base, samples = http_app
    outs = [None] * 8

    def call(i):
        outs[i] = _post(base + "/query",
                        {"query": samples[i % len(samples)]["question"]})

    ts = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert all(o[0] == 200 and o[1]["hits"] for o in outs)


def test_a_burst_of_concurrent_clients_is_served(http_app):
    """64 clients connecting at once: the front's listen backlog (128) holds
    them all (the stdlib's 5 reset connections under such a burst)."""
    base, samples = http_app
    outs = [None] * 64
    go = threading.Event()

    def call(i):
        go.wait()
        try:
            outs[i] = _post(base + "/query",
                            {"query": samples[i % len(samples)]["question"]})
        except OSError as e:
            outs[i] = (None, repr(e))

    ts = [threading.Thread(target=call, args=(i,)) for i in range(64)]
    for t in ts:
        t.start()
    go.set()
    for t in ts:
        t.join()
    assert [o[0] for o in outs] == [200] * 64, [o for o in outs if o[0] != 200][:3]
    srv = t_serve.make_server("127.0.0.1", 0, None)
    srv.server_close()
    assert srv.request_queue_size == 128


def test_error_paths(http_app):
    base, _ = http_app
    assert _post(base + "/query", {})[0] == 400
    assert _post(base + "/query_batch", {"queries": "nope"})[0] == 400
    assert _post(base + "/nope", {})[0] == 404
    assert _post(base + "/answer", {"question": "x"})[0] == 404  # --qa off
    code, out = _get(base + "/healthz")
    assert code == 200 and out["stats"]["queries"] > 0


class _Args:
    settings = ""
    top_k = 5
    max_batch = 64

    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_packed")
    samples = SyntheticHotpotQALoader({"count": 6, "seed": 3}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    build_packed_index(corpus, embed_dim=32, embed_dtype="float32",
                       out_dir=str(root / "packed"))
    return str(root / "packed"), samples, len(corpus)


def test_build_engine_from_packed_index(packed):
    path, samples, n = packed
    eng, n_docs, _ = t_serve.build_engine(_Args(index=path, device="cpu"))
    assert n_docs == n and eng.device.type == "cpu"
    res = eng.query_batch([samples[0]["question"]])
    hits = eng.hydrate_hits(res, 0)
    assert hits and hits[0].id.startswith("sent::")


def test_main_without_a_device_asks_for_the_card(packed):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_serve.main(["--index", packed[0], "--port", "0"])


def test_build_engine_from_settings_on_a_device(tmp_path, monkeypatch):
    """--settings with --device: the system (and its one engine) on that
    device, built from a copy of the settings with the device key; /answer
    answers through the same cached system."""
    samples = SyntheticHotpotQALoader({"count": 4, "seed": 11}).load()
    docs = tmp_path / "docs.jsonl"
    t_ingest(samples, graph_root=tmp_path / "g", docs_out=docs,
             build_graphs=False)
    s = json.loads((REPO / "config" / "settings_torch.json").read_text())
    s["modules"]["retrieval"]["impl_kwargs"].update(
        index_path=str(docs), graph_root=str(tmp_path / "g"))
    s["modules"]["graph_construction"]["impl_kwargs"]["root_dir"] = str(
        tmp_path / "qg")
    s["dataset"] = {"type": "synthetic_hotpotqa", "count": 4, "seed": 11}
    (tmp_path / "s.json").write_text(json.dumps(s))
    monkeypatch.chdir(tmp_path)  # /answer writes its traces under ./runs
    t_system.reset_system_cache()
    try:
        eng, n_docs, settings_path = t_serve.build_engine(
            _Args(index="", settings=str(tmp_path / "s.json"), device="cpu"),
            work_dir=tmp_path / "work")
        assert eng.device.type == "cpu" and n_docs > 0
        assert Path(settings_path).parent == tmp_path / "work"
        assert json.loads(open(settings_path).read())["device"] == "cpu"
        with QueryServer(eng, max_batch=8) as qs:
            app = t_serve._App(qs, n_docs, settings_path=settings_path, qa=True)
            code, res = app.handle("/answer",
                                   {"question": samples[0]["question"]})
        assert code == 200 and res["reasoning"]["answer"]
        ctx = t_system.get_node_ctx(settings_path)
        assert ctx.retriever.backend.engine is eng
    finally:
        t_system.reset_system_cache()


def test_app_handle_matches_jax(tmp_path):
    samples = SyntheticHotpotQALoader(
        {"count": 8, "seed": 5, "unique_entities": True,
         "n_distractors": 1}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    assert len(corpus) <= 64
    build_packed_index(corpus, embed_dim=32, embed_dtype="float32",
                       out_dir=str(tmp_path / "packed"))
    t_idx = PackedIndex.load(str(tmp_path / "packed"))
    j_idx = JPackedIndex.load(str(tmp_path / "packed"))
    t_eng = TorchQueryEngine(t_idx, device="cpu",
                             config=EngineConfig(**PARITY_CFG))
    j_eng = TPUQueryEngine(j_idx, config=JEngineConfig(**PARITY_CFG))
    qs = [s["question"] for s in samples]
    requests = ([("/query", {"query": q}) for q in qs[:4]]
                + [("/query", {"query": qs[4], "top_k": 3, "mode": "iterative"}),
                   ("/query_batch", {"queries": qs[:6]}),
                   ("/query_batch", {"queries": qs[2:8], "mode": "iterative"})])
    with QueryServer(t_eng, max_batch=16) as t_qs, \
            JQueryServer(j_eng, max_batch=16) as j_qs:
        t_app = t_serve._App(t_qs, t_idx.n_docs)
        j_app = j_serve._App(j_qs, j_idx.n_docs)
        for path, body in requests:
            t_code, t_out = t_app.handle(path, body)
            j_code, j_out = j_app.handle(path, body)
            assert t_code == j_code == 200
            rows_t = t_out.get("results") or [t_out["hits"]]
            rows_j = j_out.get("results") or [j_out["hits"]]
            assert len(rows_t) == len(rows_j)
            for rt, rj in zip(rows_t, rows_j):
                assert [h["id"] for h in rt] == [h["id"] for h in rj], body
                np.testing.assert_allclose([h["score"] for h in rt],
                                           [h["score"] for h in rj],
                                           atol=ATOL)
        t_health = t_app.handle("/healthz", None)[1]
        j_health = j_app.handle("/healthz", None)[1]
        assert t_health["corpus"] == j_health["corpus"]
        assert sorted(t_health["stats"]) == sorted(j_health["stats"])
