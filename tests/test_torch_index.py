"""Port's index build, residency and host prep vs the JAX package's.

Everything here is host integer / bit-pattern data or host f32 computed
by the same code, so equality is exact.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from a_modular_rag_framework_torch import _host
from a_modular_rag_framework_torch.engine import host_prep as t_prep
from a_modular_rag_framework_torch.engine.query_engine import \
    EngineConfig as TorchEngineConfig
from a_modular_rag_framework_torch.index import PackedIndex as TorchPackedIndex
from a_modular_rag_framework_torch.index import SentenceCorpus as TorchCorpus
from a_modular_rag_framework_torch.index import bm25 as t_bm25
from a_modular_rag_framework_torch.index import \
    build_packed_index as torch_build
from a_modular_rag_framework_torch.index import builder as t_builder
from a_modular_rag_framework_tpu.core.dataset_loader import \
    SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.engine import query_engine as jq
from a_modular_rag_framework_tpu.index.builder import (build_packed_index,
                                                       build_sentence_graph)
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
from a_modular_rag_framework_tpu.index.packed import PackedIndex
from a_modular_rag_framework_tpu.native.binding import NativeVocab
from a_modular_rag_framework_tpu.ops.bm25 import Bm25DeviceIndex

BM25_FIELDS = ("doc_ids", "tfs", "row_ptr", "df", "doc_lens", "scores")


@pytest.fixture(scope="module")
def samples():
    return SyntheticHotpotQALoader({"count": 24, "seed": 3, "n_distractors": 4,
                                    "collide_entities": True}).load()


@pytest.fixture(scope="module")
def jax_index(samples):
    return build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                              embed_dim=32, embed_dtype="bfloat16")


@pytest.fixture(scope="module")
def torch_index(samples):
    return torch_build(TorchCorpus.from_hotpotqa(samples), embed_dim=32,
                       embed_dtype="bfloat16")


def _from_jax(idx):
    return TorchPackedIndex.from_arrays(
        docs=idx.corpus.docs, embeddings=idx.embeddings,
        embed_dtype=idx.embed_dtype, bm25_doc_ids=idx.bm25.doc_ids,
        bm25_tfs=idx.bm25.tfs, bm25_row_ptr=idx.bm25.row_ptr,
        bm25_df=idx.bm25.df, bm25_doc_lens=idx.bm25.doc_lens,
        vocab=idx.bm25.vocab, k1=idx.bm25.k1, b=idx.bm25.b,
        bm25_scores=idx.bm25.scores, graph_next=idx.graph_next,
        graph_entity=idx.graph_entity, manifest=idx.manifest)


def _assert_uploads_equal(t_idx, j_idx):
    """The port's device tensors equal the JAX upload, bf16 bits included."""
    j_emb = np.asarray(j_idx.device_embeddings())
    t_emb = t_idx.device_embeddings("cpu")
    assert t_emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_emb.view(torch.int16).numpy(),
                                  j_emb.view(np.int16))
    j_bm = j_idx.device_bm25()
    t_bm = t_idx.device_bm25("cpu")
    assert set(t_bm) == set(j_bm)
    for key, val in j_bm.items():
        np.testing.assert_array_equal(t_bm[key].numpy(), np.asarray(val),
                                      err_msg=key)
    for include in (True, False):
        np.testing.assert_array_equal(
            t_idx.device_graph("cpu", include_entity=include).numpy(),
            np.asarray(j_idx.device_graph(include_entity=include)))


def test_builder_equals_jax_builder(jax_index, torch_index):
    j, t = jax_index, torch_index
    assert t.n_docs == j.n_docs and t.corpus.docs == j.corpus.docs
    np.testing.assert_array_equal(t.embeddings, j.embeddings)
    assert t.bm25.vocab == j.bm25.vocab
    for f in BM25_FIELDS:
        np.testing.assert_array_equal(getattr(t.bm25, f), getattr(j.bm25, f),
                                      err_msg=f)
    np.testing.assert_array_equal(t.graph_next, j.graph_next)
    np.testing.assert_array_equal(t.graph_entity, j.graph_entity)
    # phrase tokens made it into the vocab on both sides
    assert any("00" in term for term in t.bm25.vocab)


def test_builder_uploads_equal_jax(jax_index, torch_index):
    _assert_uploads_equal(torch_index, jax_index)


def test_from_arrays_equals_jax_upload(jax_index):
    _assert_uploads_equal(_from_jax(jax_index), jax_index)


def test_from_arrays_f32_embeddings(samples):
    j = build_packed_index(SentenceCorpus.from_hotpotqa(samples[:6]),
                           embed_dim=16, embed_dtype="float32")
    t = _from_jax(j)
    emb = t.device_embeddings("cpu")
    assert emb.dtype == torch.float32
    np.testing.assert_array_equal(emb.numpy(), np.asarray(j.device_embeddings()))


def test_load_of_jax_saved_index(jax_index, tmp_path):
    jax_index.save(tmp_path / "jax")
    t = TorchPackedIndex.load(tmp_path / "jax", verify_checksums=True)
    assert t.corpus.docs == jax_index.corpus.docs
    # loaded without precomputed scores: ensure_scores recomputes them
    _assert_uploads_equal(t, PackedIndex.load(tmp_path / "jax"))


def test_jax_loads_port_saved_index(torch_index, jax_index, tmp_path):
    torch_index.save(tmp_path / "port")
    j = PackedIndex.load(tmp_path / "port", verify_checksums=True)
    assert j.corpus.docs == jax_index.corpus.docs
    np.testing.assert_array_equal(
        j.embeddings, np.asarray(jax_index.device_embeddings()).view(np.uint16))
    # both sides recompute the (unsaved) contributions the same way
    _assert_uploads_equal(TorchPackedIndex.load(tmp_path / "port"), j)


def test_entity_graph_python_fallback_equals_jax(jax_index, samples):
    """The port's Python entity graph (used when the native library does
    not build) equals the JAX Python builder and the native table."""
    corpus = SentenceCorpus.from_hotpotqa(samples)
    j = build_sentence_graph(corpus, max_degree=32, use_native=False)
    t = t_builder._entity_graph_python(corpus.texts(), 32, 64)
    np.testing.assert_array_equal(t, j["entity"])
    np.testing.assert_array_equal(t, jax_index.graph_entity)


def test_bm25_python_build_equals_jax(samples):
    texts = SentenceCorpus.from_hotpotqa(samples[:8]).texts()
    j = Bm25DeviceIndex.build_python(texts)
    t = t_bm25.Bm25Index.build_python(texts)
    assert t.vocab == j.vocab
    for f in BM25_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


@pytest.mark.parametrize("doc_cap", [64, 4])
def test_doc_major_padded_equals_jax(jax_index, doc_cap):
    """doc_cap=4 truncates long rows to their top contributions."""
    j = jax_index.bm25
    t = t_bm25.Bm25Index(**{f.name: getattr(j, f.name)
                            for f in dataclasses.fields(t_bm25.Bm25Index)})
    for a, b in zip(t.doc_major_padded(doc_cap), j.doc_major_padded(doc_cap)):
        np.testing.assert_array_equal(a, b)


def test_ensure_scores_recompute_equals_jax(jax_index):
    j = jax_index.bm25
    kw = {f.name: getattr(j, f.name)
          for f in dataclasses.fields(t_bm25.Bm25Index)}
    kw["scores"] = None
    np.testing.assert_array_equal(t_bm25.Bm25Index(**kw).ensure_scores(),
                                  Bm25DeviceIndex(**kw).ensure_scores())


def test_engine_config_fields_and_defaults_equal_jax():
    j = {f.name: f.default for f in dataclasses.fields(jq.EngineConfig)}
    t = {f.name: f.default for f in dataclasses.fields(TorchEngineConfig)}
    assert t == j
    with pytest.raises(ValueError):
        TorchEngineConfig(order_alphas=(0.5, 0.5))
    assert TorchEngineConfig(order_alphas=[1, 0, 0]).order_alphas == (1.0, 0.0, 0.0)


def test_pick_bucket_and_trim_equal_jax():
    for b in (1, 5, 8, 9, 300, 5000):
        assert t_prep.pick_bucket((1, 8, 64, 256), b) == jq.pick_bucket(
            (1, 8, 64, 256), b)
    rng = np.random.default_rng(0)
    for used in (1, 7, 9, 20, 32):
        ids = np.full((3, 2, 32), -1, np.int32)
        ids[1, 0, :used] = rng.integers(0, 50, used)
        np.testing.assert_array_equal(t_prep.trim_term_bucket(ids, 32),
                                      jq.trim_term_bucket(ids, 32))
    empty = np.full((2, 1, 32), -1, np.int32)
    np.testing.assert_array_equal(t_prep.trim_term_bucket(empty, 32),
                                  jq.trim_term_bucket(empty, 32))


def test_query_prep_equals_jax(jax_index, samples):
    bm25 = jax_index.bm25
    high = t_prep.build_high_df_terms(bm25, 0.05, jax_index.n_docs)
    assert high == jq.build_high_df_terms(bm25, 0.05, jax_index.n_docs)
    assert t_prep.build_high_df_terms(bm25, 0.0, jax_index.n_docs) is None
    queries = [s["question"] for s in samples[:10]] + [
        "", "lowercase only words here", "The The The"]
    pruned = [t_prep.prune_query(q, high) for q in queries]
    assert pruned == [jq.prune_query(q, high) for q in queries]
    expansions = [[q.upper()] for q in queries]
    tv = t_prep.prepare_query_variants(pruned, expansions, 16, 4)
    jv = jq.prepare_query_variants(pruned, expansions, 16, 4)
    assert tv == jv
    variants, E = tv
    native = NativeVocab(bm25.vocab)
    for nv in ((native if native.available else None), None):
        np.testing.assert_array_equal(
            t_prep.encode_query_term_ids(variants, E, 32, bm25.vocab, nv),
            jq.encode_query_term_ids(variants, E, 32, bm25.vocab, nv))


def test_shared_host_modules_load_by_path():
    """The port's own corpus and loader modules (no longer loaded by path
    from the JAX package) live in the port's tree, are what
    ``index.SentenceCorpus`` names, and give what the originals give."""
    from a_modular_rag_framework_torch.core import dataset_loader as loader
    from a_modular_rag_framework_torch.index import corpus as corpus_mod

    port = Path(_host.__file__).resolve().parent
    for mod in (loader, corpus_mod):
        assert Path(mod.__file__).resolve().is_relative_to(port)
    assert TorchCorpus is corpus_mod.SentenceCorpus
    assert not hasattr(_host, "load_shared_module")
    docs = [{"doc_id": "A#0", "title": "A", "sent_id": 0, "text": "x"}]
    c = corpus_mod.SentenceCorpus(docs=docs)
    assert c.hit_id(0) == SentenceCorpus(docs=docs).hit_id(0)
    assert c.hit_meta(0) == SentenceCorpus(docs=docs).hit_meta(0)
    cfg = {"count": 3, "seed": 1}
    assert (loader.SyntheticHotpotQALoader(cfg).load()
            == SyntheticHotpotQALoader(cfg).load())


def test_require_device():
    assert _host.require_device("cpu") == torch.device("cpu")
    with pytest.raises(TypeError):
        _host.require_device(None)
    with pytest.raises(ValueError):
        _host.require_device("meta")


def test_device_upload_of_memory_mapped_arrays(jax_index, tmp_path):
    """Memory-mapped (read-only) arrays are copied on upload."""
    jax_index.save(tmp_path / "mm")
    t = TorchPackedIndex.load(tmp_path / "mm", mmap=True)
    nbrs = t.device_graph("cpu")
    nbrs.add_(0)  # writable: not aliasing the read-only mapping
    np.testing.assert_array_equal(
        nbrs.numpy(), np.asarray(jax_index.device_graph()))
