"""`answer_question` of the port vs the JAX package, on the CPU.

Everything here passes ``device="cpu"`` (or a settings file with
``"device": "cpu"``): without it the port asks for the card. The corpora are
the in-repo synthetic generator's; ``unique_entities`` makes them tie-free,
so hit ids must be identical and scores agree within ATOL = 1e-5 (the
engines' f32 programs differ by summation order only). With the committed
bf16 checkpoints (``data/encoder.npz``, ``data/cross_encoder.npz``) scores
agree within BF16_ATOL = 2e-2, the tolerance of ``test_torch_models.py``.
Host outputs (graph nodes, edge sets, answers, verdicts) are equal exactly;
edge weights and semantic similarities within 1e-6.

The JAX tests run on eight virtual CPU devices, where the shipped
``mesh: {axes: {data: -1}}`` would select the JAX package's sharded engine;
the JAX side is given an empty mesh and both packages serve from one device
(the port on the CPU sees one device). The port's sharded engine serves the
shipped mesh where the visible device count is monkeypatched above one.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from a_modular_rag_framework_torch import system as t_system
from a_modular_rag_framework_torch.cli.ingest_hotpotqa import ingest as t_ingest
from a_modular_rag_framework_torch.core.dataset_loader import (
    SyntheticHotpotQALoader)
from a_modular_rag_framework_torch.core.dto import GraphBuildIn as TGraphBuildIn
from a_modular_rag_framework_torch.core.dto import RetrievalIn as TRetrievalIn
from a_modular_rag_framework_torch.di import factory as t_factory
from a_modular_rag_framework_torch.engine import EngineConfig, TorchQueryEngine
from a_modular_rag_framework_torch.eval.metrics import contains_match
from a_modular_rag_framework_torch.index import PackedIndex as TPackedIndex
from a_modular_rag_framework_torch.modules.graph_construction.flow import (
    GraphConstructionFlow as TGraphFlow)
from a_modular_rag_framework_torch.modules.retrieval import torch_backend
from a_modular_rag_framework_torch.modules.retrieval.torch_backend import (
    TorchHybridRetrievalBackend, load_or_build_packed_index)
from a_modular_rag_framework_torch.parallel import ShardedHybridEngine
from a_modular_rag_framework_torch.parallel.mesh import resolve_axes
from a_modular_rag_framework_torch.telemetry.sinks import LocalJsonlSink
from a_modular_rag_framework_tpu import system as j_system
from a_modular_rag_framework_tpu.cli.ingest_hotpotqa import ingest as j_ingest
from a_modular_rag_framework_tpu.core.dto import GraphBuildIn as JGraphBuildIn
from a_modular_rag_framework_tpu.core.dto import RetrievalIn as JRetrievalIn
from a_modular_rag_framework_tpu.di import factory as j_factory
from a_modular_rag_framework_tpu.index.packed import PackedIndex as JPackedIndex
from a_modular_rag_framework_tpu.modules.graph_construction.flow import (
    GraphConstructionFlow as JGraphFlow)
from a_modular_rag_framework_tpu.modules.retrieval import tpu_backend
from a_modular_rag_framework_tpu.modules.retrieval.tpu_backend import (
    TPUHybridRetrievalBackend)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
BF16_ATOL = 2e-2
N_SAMPLES = 6
NAME_MAP = (
    ("a_modular_rag_framework_tpu", "a_modular_rag_framework_torch"),
    ("tpu_embed_provider:TPUEmbedProvider",
     "torch_embed_provider:TorchEmbedProvider"),
    ("tpu_backend:TPUHybridRetrievalBackend",
     "torch_backend:TorchHybridRetrievalBackend"),
    ("tpu-hash-encoder", "torch-hash-encoder"),
    ("tpu_embed", "torch_embed"),
)


def _to_port_names(obj):
    if isinstance(obj, dict):
        return {_to_port_names(k): _to_port_names(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_port_names(x) for x in obj]
    if isinstance(obj, str):
        for old, new in NAME_MAP:
            obj = obj.replace(old, new)
    return obj


def _settings_pair(root: Path, docs: Path, *, count=N_SAMPLES, seed=11):
    """(JAX settings path, port settings path): the shipped files pointed at
    ``docs`` and at one graph root each, two self-consistency runs."""
    out = []
    for tag in ("j", "t"):
        if tag == "j":
            base = yaml.safe_load((REPO / "config/settings.yaml").read_text())
            base["mesh"] = {"axes": {}}  # one device, as the port serves
        else:
            base = json.loads((REPO / "config/settings_torch.json").read_text())
            base["device"] = "cpu"
        base["dataset"] = {"type": "synthetic_hotpotqa", "count": count,
                           "seed": seed}
        rcfg = base["modules"]["retrieval"]["impl_kwargs"]
        rcfg["index_path"] = str(docs)
        rcfg["graph_root"] = str(root / tag / "graph")
        base["modules"]["graph_construction"]["impl_kwargs"]["root_dir"] = str(
            root / tag / "graph")
        base["modules"]["verification"]["impl_kwargs"]["sc_runs"] = 2
        path = root / f"settings_{tag}.{'yaml' if tag == 'j' else 'json'}"
        path.write_text(yaml.safe_dump(base) if tag == "j"
                        else json.dumps(base))
        out.append(str(path))
    return out


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """One corpus ingested by the port, and a settings file per package."""
    root = tmp_path_factory.mktemp("torch_e2e")
    samples = SyntheticHotpotQALoader({"count": N_SAMPLES, "seed": 11}).load()
    docs = root / "data" / "docs.jsonl"
    stats = t_ingest(samples, graph_root=root / "data" / "graph_ingest",
                     docs_out=docs, build_graphs=True, pack=True)
    assert stats["sentences"] > 0
    j_path, t_path = _settings_pair(root, docs)
    t_system.reset_system_cache()
    j_system.reset_system_cache()
    return {"root": root, "settings": t_path, "j_settings": j_path,
            "samples": samples, "runs": str(root / "runs"),
            "j_runs": str(root / "j_runs")}


# ---------------- settings ----------------


def test_settings_file_is_the_shipped_yaml_with_the_ports_names():
    shipped = yaml.safe_load((REPO / "config/settings.yaml").read_text())
    port = json.loads((REPO / "config/settings_torch.json").read_text())
    assert _to_port_names(shipped) == port
    assert "device" not in port  # the card is the default
    # JSON is YAML: either package's loader reads the port's file
    assert yaml.safe_load(
        (REPO / "config/settings_torch.json").read_text()) == port
    assert j_factory.load_settings(
        str(REPO / "config/settings_torch.json")) == port
    assert t_factory.load_settings(
        str(REPO / "config/settings_torch.json")) == port
    assert t_factory.load_settings(
        str(REPO / "config/settings.yaml")) == shipped  # PyYAML is here


def test_yaml_settings_without_pyyaml_raise_a_clear_error(monkeypatch, tmp_path):
    import builtins
    real = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError("No module named 'yaml'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    with pytest.raises(ImportError, match="PyYAML"):
        t_factory.load_settings(str(REPO / "config/settings.yaml"))
    (tmp_path / "s.json").write_text('{"a": 1}')
    assert t_factory.load_settings(str(tmp_path / "s.json")) == {"a": 1}


def test_factory_helpers_equal_the_jax_packages():
    cfg = {"m": {"type": "pkg.f:F", "kwargs": {"x": 2}, "impl": "pkg.i:I",
                 "impl_kwargs": {"y": 3}},
           "s": "pkg.mod:Cls", "i": {"impl": "pkg.i:I", "kwargs": {"a": 1}}}
    for key in ("m", "s", "i", "missing"):
        assert (t_factory.parse_module_spec(copy.deepcopy(cfg), key, "d:D")
                == j_factory.parse_module_spec(copy.deepcopy(cfg), key, "d:D"))

    class Thing:
        def __init__(self, a, router=None):
            pass

    args = ({"a": 1, "junk": 9},)
    kw = {"inject": {"router": "R", "sink": "S"}}
    assert (t_factory.filtered_kwargs(Thing, *args, **kw)
            == j_factory.filtered_kwargs(Thing, *args, **kw))
    assert t_factory.resolve_env("${HOME}") == j_factory.resolve_env("${HOME}")
    assert (t_factory.import_from_string(
        "a_modular_rag_framework_torch.core.dto:Hit")
        is t_factory.import_from_string(
            "a_modular_rag_framework_torch.core.dto.Hit"))


def test_device_key_reaches_every_device_component():
    base = json.loads((REPO / "config/settings_torch.json").read_text())
    assert t_factory.with_device(base) is base
    out = t_factory.with_device(dict(base, device="cpu"))
    gc = out["modules"]["graph_construction"]["impl_kwargs"]
    assert gc["edge_builder"]["device"] == "cpu"
    assert "device" not in base["modules"]["graph_construction"][
        "impl_kwargs"]["edge_builder"]
    providers = t_factory.build_providers(dict(base, device="cpu"))
    assert providers["torch_embed"].device == torch.device("cpu")
    assert set(providers) == {"mock", "openai", "torch_embed"}
    router = t_factory.build_router(base, providers)
    vecs = np.array(router.embed(texts=["the quick brown fox",
                                        "the quick brown fox jumps"]))
    j_providers = j_factory.build_providers(
        yaml.safe_load((REPO / "config/settings.yaml").read_text()))
    j_router = j_factory.build_router(
        yaml.safe_load((REPO / "config/settings.yaml").read_text()), j_providers)
    np.testing.assert_array_equal(vecs, np.array(j_router.embed(
        texts=["the quick brown fox", "the quick brown fox jumps"])))
    assert router.resolve_embed_model() == "torch-hash-encoder"


def test_without_a_device_key_the_system_asks_for_the_card(env, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    s = json.loads(Path(env["settings"]).read_text())
    del s["device"]
    path = tmp_path / "card.json"
    path.write_text(json.dumps(s))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_system.init_system(str(path), runs_dir=str(tmp_path / "runs"),
                             use_cache=False)


# ---------------- graph construction ----------------


def _graph_flows(env):
    t_set = t_factory.load_settings(env["settings"])
    j_set = j_factory.load_settings(env["j_settings"])
    t_router = t_factory.build_router(t_set, t_factory.build_providers(t_set))
    j_router = j_factory.build_router(j_set, j_factory.build_providers(j_set))
    return (TGraphFlow.from_settings(t_factory.with_device(t_set),
                                     router=t_router),
            JGraphFlow.from_settings(j_set, router=j_router))


@pytest.mark.parametrize("which", [0, 3])
def test_graph_construction_matches_jax(env, which):
    t_flow, j_flow = _graph_flows(env)
    assert t_flow.edge_builder.device == "cpu"
    s = env["samples"][which]
    kw = dict(trace_id="t", question_text=s["question"],
              context=s["context"], graph_id=f"parity-{which}")
    t_out = t_flow.build(TGraphBuildIn(**kw))
    j_out = j_flow.build(JGraphBuildIn(**kw))
    assert (t_out.node_count, t_out.edge_count) == (j_out.node_count,
                                                    j_out.edge_count)
    t_dir = env["root"] / "t" / "graph" / kw["graph_id"]
    j_dir = env["root"] / "j" / "graph" / kw["graph_id"]
    tg = json.loads((t_dir / "graph.json").read_text())
    jg = json.loads((j_dir / "graph.json").read_text())
    assert [n["id"] for n in tg["nodes"]] == [n["id"] for n in jg["nodes"]]
    assert tg["nodes"] == jg["nodes"]
    key = lambda e: (e["source"], e["target"], e["type"])
    assert [key(e) for e in tg["edges"]] == [key(e) for e in jg["edges"]]
    np.testing.assert_allclose([e.get("weight", 1.0) for e in tg["edges"]],
                               [e.get("weight", 1.0) for e in jg["edges"]],
                               atol=1e-6)
    assert any(e["type"] == "q_match" for e in tg["edges"])
    ta = np.load(t_dir / "adjacency.npz", allow_pickle=False)
    ja = np.load(j_dir / "adjacency.npz", allow_pickle=False)
    assert sorted(ta.files) == sorted(ja.files)
    for f in ta.files:
        if ta[f].dtype.kind == "f":
            np.testing.assert_allclose(ta[f], ja[f], atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(ta[f], ja[f], err_msg=f)


# ---------------- the backend ----------------


@pytest.fixture(scope="module")
def tie_free(tmp_path_factory):
    """A tie-free corpus (unique entities) ingested once, with per-question
    graphs written by the port's flow (both backends read them for seeds).
    One distractor per sample keeps it under 64 rows: the BM25 pool (200)
    and the derived graph seeds (the engine's top 64 BM25 rows) then hold
    every scoring row, so no cut runs through equal BM25 scores, which
    template sentences have and the two packages' sorts break differently."""
    root = tmp_path_factory.mktemp("torch_backend")
    samples = SyntheticHotpotQALoader(
        {"count": 8, "seed": 5, "unique_entities": True,
         "n_distractors": 1}).load()
    docs = root / "docs.jsonl"
    stats = t_ingest(samples, graph_root=root / "ingest_graphs", docs_out=docs,
                     build_graphs=False, pack=True)
    assert 32 <= stats["sentences"] <= 64
    j_path, t_path = _settings_pair(root, docs, count=8, seed=5)
    t_set = t_factory.load_settings(t_path)
    j_set = j_factory.load_settings(j_path)
    t_router = t_factory.build_router(t_set, t_factory.build_providers(t_set))
    j_router = j_factory.build_router(j_set, j_factory.build_providers(j_set))
    flow = TGraphFlow.from_settings(t_factory.with_device(t_set), router=t_router)
    graph_root = root / "t" / "graph"
    for i, s in enumerate(samples[:4]):
        flow.build(TGraphBuildIn(trace_id="t", question_text=s["question"],
                                 context=s["context"], graph_id=f"q{i}"))
    return {"root": root, "docs": docs, "samples": samples,
            "graph_root": str(graph_root), "t_router": t_router,
            "j_router": j_router}


BACKEND_KW = dict(graph_window=1, default_top_k=10, bm25_pool_k=200,
                  graph_wave_dtype="float32", batch_buckets=(1, 8),
                  bm25_term_topm=128)
TIMING_KEYS = ("device_ms", "resolved_embed_model", "graph_impl")


def _backends(tie_free, **over):
    kw = dict(BACKEND_KW, graph_root=tie_free["graph_root"],
              **{"index_path": str(tie_free["docs"]), **over})
    return (TorchHybridRetrievalBackend(router=tie_free["t_router"],
                                        device="cpu", **kw),
            TPUHybridRetrievalBackend(router=tie_free["j_router"], **kw))


def _assert_same_retrieval(t_out, j_out, atol):
    assert [h.id for h in t_out.hits] == [h.id for h in j_out.hits]
    np.testing.assert_allclose([h.score for h in t_out.hits],
                               [h.score for h in j_out.hits], atol=atol)
    for th, jh in zip(t_out.hits, j_out.hits):
        assert th.meta.keys() == jh.meta.keys()
        for k, v in th.meta.items():
            if isinstance(v, float):
                assert v == pytest.approx(jh.meta[k], abs=atol), k
            else:
                assert v == jh.meta[k], k
    # the port's engine also names its graph form; timings differ
    td = {k: v for k, v in t_out.diagnostics.items() if k not in TIMING_KEYS}
    jd = {k: v for k, v in j_out.diagnostics.items() if k not in TIMING_KEYS}
    assert td == jd
    assert t_out.diagnostics["resolved_embed_model"] == "torch-hash-encoder"


@pytest.mark.parametrize("seeds", ["qmatch", "bm25_weighted"])
@pytest.mark.parametrize("hops", [1, 2], ids=["single_pass", "iterative"])
def test_backend_matches_jax(tie_free, hops, seeds):
    t_be, j_be = _backends(tie_free, iterative_hops=hops)
    for i, s in enumerate(tie_free["samples"][:4]):
        kw = dict(query=s["question"], top_k=10, trace_id="t",
                  graph_id=f"q{i}" if seeds == "qmatch" else "")
        t_out = t_be.retrieve(TRetrievalIn(**kw))
        j_out = j_be.retrieve(JRetrievalIn(**kw))
        assert t_out.diagnostics["seed_mode"] == seeds
        assert len(t_out.hits) == 10
        _assert_same_retrieval(t_out, j_out, ATOL)
    # the per-request window override reaches the engine
    kw = dict(query=tie_free["samples"][0]["question"], top_k=5,
              trace_id="t", graph_window=2)
    t_out, j_out = (t_be.retrieve(TRetrievalIn(**kw)),
                    j_be.retrieve(JRetrievalIn(**kw)))
    assert t_out.diagnostics["graph_window_used"] == 2
    _assert_same_retrieval(t_out, j_out, ATOL)


def test_backend_empty_corpus_falls_back_to_the_graph(tie_free, tmp_path):
    t_be, j_be = _backends(tie_free, index_path=str(tmp_path / "none.jsonl"))
    s = tie_free["samples"][1]
    kw = dict(query=s["question"], top_k=10, trace_id="t", graph_id="q1")
    t_out, j_out = (t_be.retrieve(TRetrievalIn(**kw)),
                    j_be.retrieve(JRetrievalIn(**kw)))
    assert t_out.diagnostics["fallback"] == "graph_sentences"
    assert t_out.hits
    _assert_same_retrieval(t_out, j_out, ATOL)
    assert t_be._ephemeral_engine("q1") is t_be._ephemeral_engine("q1")
    assert t_be._ephemeral_engine("q1").device == torch.device("cpu")


def test_backend_with_the_committed_cross_encoder(tie_free):
    t_be, j_be = _backends(
        tie_free, cross_rerank_weights=str(REPO / "data/cross_encoder.npz"),
        cross_rerank_top_m=5)
    s = tie_free["samples"][0]
    kw = dict(query=s["question"], top_k=10, trace_id="t")
    t_out, j_out = (t_be.retrieve(TRetrievalIn(**kw)),
                    j_be.retrieve(JRetrievalIn(**kw)))
    assert t_out.diagnostics["cross_reranked"] == 5
    assert "cross_score" in t_out.hits[0].meta
    assert "cross_score" not in t_out.hits[5].meta
    assert [h.id for h in t_out.hits] == [h.id for h in j_out.hits]
    np.testing.assert_allclose(
        [h.meta["cross_score"] for h in t_out.hits[:5]],
        [h.meta["cross_score"] for h in j_out.hits[:5]], atol=BF16_ATOL)


def test_backend_with_the_committed_encoder(tie_free, tmp_path):
    """A learned encoder builds its own index: each backend from its own
    copy of docs.jsonl (the caches would otherwise be shared)."""
    outs = []
    for tag, cls, router, req in (
            ("t", TorchHybridRetrievalBackend, tie_free["t_router"], TRetrievalIn),
            ("j", TPUHybridRetrievalBackend, tie_free["j_router"], JRetrievalIn)):
        docs = tmp_path / tag / "docs.jsonl"
        docs.parent.mkdir()
        docs.write_bytes(tie_free["docs"].read_bytes())
        kw = dict(BACKEND_KW, index_path=str(docs),
                  graph_root=tie_free["graph_root"],
                  encoder_weights=str(REPO / "data/encoder.npz"),
                  router=router, **({"device": "cpu"} if tag == "t" else {}))
        be = cls(**kw)
        outs.append(be.retrieve(req(query=tie_free["samples"][2]["question"],
                                    top_k=10, trace_id="t")))
    t_out, j_out = outs
    # bf16 embeddings can swap near-equal fused scores: same hits, and the
    # same order wherever the JAX scores are further apart than the tolerance
    assert {h.id for h in t_out.hits} == {h.id for h in j_out.hits}
    j_score = {h.id: h.score for h in j_out.hits}
    np.testing.assert_allclose([h.score for h in t_out.hits],
                               [j_score[h.id] for h in t_out.hits],
                               atol=BF16_ATOL)


def test_packed_directory_interchanges(tmp_path):
    samples = SyntheticHotpotQALoader({"count": 4, "seed": 2}).load()
    for tag, ingest in (("t", t_ingest), ("j", j_ingest)):
        ingest(samples, graph_root=tmp_path / tag / "g",
               docs_out=tmp_path / tag / "docs.jsonl", build_graphs=False)
    # a directory written by either package loads in the other, and the
    # loaders never reopen docs.jsonl on a cache hit
    for tag in ("t", "j"):
        (tmp_path / tag / "docs.jsonl").unlink()
    t_from_j = load_or_build_packed_index(str(tmp_path / "j" / "docs.jsonl"))
    j_from_t = tpu_backend.load_or_build_packed_index(
        str(tmp_path / "t" / "docs.jsonl"))
    assert isinstance(t_from_j, TPackedIndex) and isinstance(j_from_t, JPackedIndex)
    assert t_from_j.n_docs == j_from_t.n_docs > 0
    np.testing.assert_array_equal(np.asarray(t_from_j.embeddings),
                                  np.asarray(j_from_t.embeddings))
    assert t_from_j.corpus.docs == j_from_t.corpus.docs
    # a cache built under the other index_titles setting is not reused
    assert load_or_build_packed_index(
        str(tmp_path / "j" / "docs.jsonl"), index_titles=True).n_docs == 0


def test_splade_index_cache_is_written_and_read(tie_free, tmp_path):
    docs = tmp_path / "docs.jsonl"
    docs.write_bytes(tie_free["docs"].read_bytes())
    t_ingest(tie_free["samples"], graph_root=tmp_path / "g", docs_out=docs,
             build_graphs=False)
    kw = dict(BACKEND_KW, index_path=str(docs), graph_root=str(tmp_path / "g"),
              sparse_impl="splade",
              splade_weights=str(REPO / "data/splade_variety.npz"),
              router=tie_free["t_router"], device="cpu")
    first = TorchHybridRetrievalBackend(**kw)
    cache = docs.with_suffix(".jsonl.packed") / "splade_index.npz"
    assert cache.exists()
    again = TorchHybridRetrievalBackend(**kw)  # loads the cache
    j_be = TPUHybridRetrievalBackend(**{
        k: v for k, v in kw.items() if k not in ("device", "router")},
        router=tie_free["j_router"])  # the JAX package reads the port's cache
    q = tie_free["samples"][0]["question"]
    a = first.retrieve(TRetrievalIn(query=q, top_k=10, trace_id="t"))
    b = again.retrieve(TRetrievalIn(query=q, top_k=10, trace_id="t"))
    j = j_be.retrieve(JRetrievalIn(query=q, top_k=10, trace_id="t"))
    assert [h.id for h in a.hits] == [h.id for h in b.hits] and a.hits
    assert [h.score for h in a.hits] == [h.score for h in b.hits]
    j_score = {h.id: h.score for h in j.hits}
    shared = [h for h in a.hits if h.id in j_score]
    assert len(shared) >= 8
    np.testing.assert_allclose([h.score for h in shared],
                               [j_score[h.id] for h in shared], atol=BF16_ATOL)


@pytest.mark.parametrize("axes,n_devices,raises", [
    ({"data": -1}, 1, False), ({"data": -1}, 4, True),
    ({"data": 2, "model": -1}, 4, True), ({"model": -1}, 4, False),
    ({"data": 4}, 1, False),  # does not fit one device: warned, single-device
])
def test_mesh_axes_over_more_than_one_device_raise(tie_free, monkeypatch,
                                                   axes, n_devices, raises):
    """``raises`` marks the meshes with more than one position on the shard
    axis: they build the sharded engine with the resolved shard count (the
    visible devices monkeypatched, every position the CPU), and a retrieval
    equals the single-device backend's."""
    monkeypatch.setattr(torch_backend, "visible_devices", lambda d: n_devices)
    kw = dict(BACKEND_KW, index_path=str(tie_free["docs"]),
              graph_root=tie_free["graph_root"], device="cpu",
              router=tie_free["t_router"], mesh_axes=axes, shard_axis="data")
    backend = TorchHybridRetrievalBackend(**kw)
    assert backend.engine.device.type == "cpu"
    if not raises:
        assert type(backend.engine) is TorchQueryEngine
        return
    want_shards = resolve_axes(axes, n_devices)["data"]
    assert isinstance(backend.engine, ShardedHybridEngine)
    assert backend.engine.n_shards == want_shards
    single = TorchHybridRetrievalBackend(**dict(kw, mesh_axes=None))
    q = tie_free["samples"][1]["question"]
    req = TRetrievalIn(query=q, graph_id="q1", top_k=10, trace_id="t")
    a, b = backend.retrieve(req), single.retrieve(req)
    assert [h.id for h in a.hits] == [h.id for h in b.hits] and a.hits
    np.testing.assert_allclose([h.score for h in a.hits],
                               [h.score for h in b.hits], atol=ATOL)
    assert a.diagnostics["n_shards"] == want_shards


def test_engine_records_device_timing_in_its_sink(tie_free, tmp_path):
    sink = LocalJsonlSink(root_dir=str(tmp_path))
    idx = load_or_build_packed_index(str(tie_free["docs"]))
    eng = TorchQueryEngine(idx, device="cpu", sink=sink,
                           config=EngineConfig(top_k=5, batch_buckets=(1, 8)))
    q = tie_free["samples"][0]["question"]
    eng.query_batch([q], trace_id="tr")
    eng.query_batch([q])  # no trace id: nothing recorded
    eng.query_batch_async([q], trace_id="late").result()  # not a sync fetch
    events = [json.loads(l) for l in
              (tmp_path / "tr" / "events.jsonl").read_text().splitlines()]
    timing = [e for e in events if e["event"] == "device_timing"]
    assert len(timing) == 1 and not (tmp_path / "late").exists()
    payload = json.dumps(timing[0])
    assert "engine/query_batch" in payload and f"B1xN{idx.n_docs}k5" in payload
    assert '"cpu"' in payload


# ---------------- answer_question as a whole ----------------


def test_full_pipeline_answers_question(env):
    s = env["samples"][0]
    res = t_system.answer_question(s["question"], mode="full",
                                   settings_path=env["settings"],
                                   runs_dir=env["runs"])
    assert res["graph"]["node_count"] > 0 and res["graph"]["edge_count"] > 0
    assert res["retrieval"]["hits"], "retrieval returned no hits"
    assert res["reasoning"]["answer"]
    assert res["verification"]["verdict"] is not None
    assert res["metrics"]["t_end"] >= res["metrics"]["t1"]
    gdir = Path(env["root"]) / "t" / "graph" / res["graph"]["graph_id"]
    g = json.loads((gdir / "graph.json").read_text())
    assert g["node_count"] == res["graph"]["node_count"]
    trace_dir = Path(env["runs"]) / res["trace_id"]
    lines = (trace_dir / "events.jsonl").read_text().splitlines()
    names = [json.loads(l).get("node") for l in lines]
    for node in ("InitExternal", "Ingest", "BuildGraph", "ChooseRoute",
                 "Retrieval", "Reasoning", "Verify", "PackResult"):
        assert node in names, f"missing span for {node}"
    assert any(json.loads(l)["event"] == "device_timing" for l in lines)
    assert (trace_dir / "run.json").exists()
    assert (trace_dir / "assets" / "flow.mmd").exists()


def test_graph_only_mode_skips_retrieval(env):
    res = t_system.answer_question(env["samples"][1]["question"],
                                   mode="graph_only",
                                   settings_path=env["settings"],
                                   runs_dir=env["runs"])
    assert res["graph"]["node_count"] > 0
    assert not res.get("retrieval") and not res.get("reasoning")


def test_retrieval_uses_qmatch_seeds_from_graph(env):
    res = t_system.answer_question(env["samples"][2]["question"], mode="full",
                                   settings_path=env["settings"],
                                   runs_dir=env["runs"])
    diag = res["retrieval"]["diagnostics"]
    assert diag["seed_mode"] == "qmatch" and diag["seed_count"] > 0


def test_system_answers_gold_on_easy_sample(env):
    hits = 0
    for s in env["samples"][:4]:
        res = t_system.answer_question(s["question"], mode="full",
                                       settings_path=env["settings"],
                                       runs_dir=env["runs"])
        hits += contains_match(res["reasoning"]["answer"], s["answer"])
    assert hits >= 1, "no question answered with the gold answer"


def test_init_system_cache_and_one_engine(env):
    wf1, sink1 = t_system.init_system(env["settings"], runs_dir=env["runs"])
    wf2, sink2 = t_system.init_system(env["settings"], runs_dir=env["runs"])
    assert wf1 is wf2 and sink1 is sink2
    ctx = t_system.get_node_ctx(env["settings"], runs_dir=env["runs"])
    engine = ctx.retriever.backend.engine
    assert engine.device == torch.device("cpu") and engine.sink is sink1
    # graph construction's bootstrap retriever shares the one engine, and
    # the verifier's claim check goes through the same backend
    assert ctx.graph_c.retriever.backend.engine is engine
    assert ctx.verifier.impl.external_claim_retriever is not None


def test_answer_question_with_the_shipped_mesh_on_four_devices(
        env, monkeypatch, tmp_path):
    """The shipped ``mesh: {axes: {data: -1}}`` over four visible devices
    (monkeypatched; every position the CPU) serves through the sharded
    engine and gives the single device's answers and verdicts."""
    monkeypatch.setattr(torch_backend, "visible_devices", lambda d: 4)
    settings = json.loads(Path(env["settings"]).read_text())
    assert settings["mesh"]["axes"] == {"data": -1}
    path = tmp_path / "settings.json"
    path.write_text(json.dumps(settings))
    runs = str(tmp_path / "runs")
    ctx = t_system.get_node_ctx(str(path), runs_dir=runs)
    engine = ctx.retriever.backend.engine
    assert isinstance(engine, ShardedHybridEngine) and engine.n_shards == 4
    for s in env["samples"][:2]:
        sharded = t_system.answer_question(s["question"], mode="full",
                                           settings_path=str(path),
                                           runs_dir=runs)
        single = t_system.answer_question(s["question"], mode="full",
                                          settings_path=env["settings"],
                                          runs_dir=env["runs"])
        assert sharded["reasoning"]["answer"] == single["reasoning"]["answer"]
        assert (sharded["verification"]["verdict"]
                == single["verification"]["verdict"])
        assert sharded["retrieval"]["diagnostics"]["n_shards"] == 4


def test_answer_question_without_ingested_corpus(tmp_path, monkeypatch):
    """No ingested corpus: the backend falls back to the per-question
    graph's sentence nodes and the system still answers."""
    monkeypatch.chdir(tmp_path)
    s = json.loads((REPO / "config/settings_torch.json").read_text())
    s["device"] = "cpu"
    (tmp_path / "settings.json").write_text(json.dumps(s))
    res = t_system.answer_question(
        "In which city was the collaborator of Sage Silverton born?",
        mode="full", settings_path=str(tmp_path / "settings.json"))
    answer = (res.get("reasoning") or {}).get("answer") or ""
    assert answer and "No supporting evidence" not in answer
    sample = next(
        s for s in SyntheticHotpotQALoader({"count": 8, "seed": 0}).load()
        if "Sage Silverton" in s["question"])
    assert sample["answer"] in answer
    diag = (res.get("retrieval") or {}).get("diagnostics") or {}
    assert diag.get("fallback") == "graph_sentences"


def _node_names(runs, trace_id):
    lines = (Path(runs) / trace_id / "events.jsonl").read_text().splitlines()
    return [e.get("node") for e in map(json.loads, lines)
            if e.get("event") == "node_start"]


@pytest.mark.parametrize("which", range(N_SAMPLES))
def test_answer_question_matches_jax(env, which):
    """The whole path: the same question through both packages'
    `answer_question` gives the same answer string, verdict, retry rounds,
    hit ids (scores within ATOL), graph size and workflow path."""
    q = env["samples"][which]["question"]
    t = t_system.answer_question(q, mode="full", settings_path=env["settings"],
                                 runs_dir=env["runs"])
    j = j_system.answer_question(q, mode="full",
                                 settings_path=env["j_settings"],
                                 runs_dir=env["j_runs"])
    assert t["reasoning"]["answer"] == j["reasoning"]["answer"]
    assert t["verification"]["verdict"] == j["verification"]["verdict"]
    assert t["verification"]["status"] == j["verification"]["status"]
    assert t["retry_round"] == j["retry_round"]
    assert t["retrieval_source"] == j["retrieval_source"]
    assert ([h["id"] for h in t["retrieval"]["hits"]]
            == [h["id"] for h in j["retrieval"]["hits"]])
    np.testing.assert_allclose([h["score"] for h in t["retrieval"]["hits"]],
                               [h["score"] for h in j["retrieval"]["hits"]],
                               atol=ATOL)
    assert ((t["graph"]["node_count"], t["graph"]["edge_count"])
            == (j["graph"]["node_count"], j["graph"]["edge_count"]))
    assert (_node_names(env["runs"], t["trace_id"])
            == _node_names(env["j_runs"], j["trace_id"]))
