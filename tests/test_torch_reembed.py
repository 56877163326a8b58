"""The learned-embedding sidecar, `build_packed_index` with a learned
encoder, and the engine / iterative 2-hop / QueryServer with a learned
`TextEncoder`, against the JAX package on the CPU.

One small encoder checkpoint (2 layers, d 32, vocab 1024, L 16, 4 subword
features, float32 compute) is saved by the JAX package and loaded by
both, so embeddings agree to summation order (ATOL) and ranked ids are
identical on the tie-free bridge corpus of tests/test_torch_multihop.py.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multihop import CFG, _assert_same_iterative, _bridge_corpus
from a_modular_rag_framework_torch.engine import EngineConfig as TConfig
from a_modular_rag_framework_torch.engine import TorchQueryEngine
from a_modular_rag_framework_torch.engine.server import QueryServer
from a_modular_rag_framework_torch.index import PackedIndex as TIndex
from a_modular_rag_framework_torch.index import SentenceCorpus as TCorpus
from a_modular_rag_framework_torch.index import build_packed_index as t_build
from a_modular_rag_framework_torch.index import packed as t_packed
from a_modular_rag_framework_torch.index import reembed as t_re
from a_modular_rag_framework_torch.models import encoder as t_enc
from a_modular_rag_framework_torch.modules.retrieval import multihop as tmh
from a_modular_rag_framework_tpu.engine.query_engine import (EngineConfig,
                                                             TPUQueryEngine)
from a_modular_rag_framework_tpu.index import reembed as j_re
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
from a_modular_rag_framework_tpu.index.packed import PackedIndex
from a_modular_rag_framework_tpu.models import encoder as j_enc
from a_modular_rag_framework_tpu.modules.retrieval import multihop as jmh

ATOL = 1e-5
ENC = dict(vocab_size=1024, max_len=16, d_model=32, n_heads=2, n_layers=2,
           d_ff=64, subword_ngrams=4)


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("enc") / "enc.npz")
    j = j_enc.TextEncoder(j_enc.EncoderConfig(dtype=jnp.float32, **ENC),
                          seed=11)
    j.save(ckpt)
    t = t_enc.TextEncoder.load(
        ckpt, t_enc.EncoderConfig(dtype=torch.float32, **ENC), device="cpu")
    return j, t, ckpt


@pytest.fixture(scope="module")
def learned(encoders):
    """Both packages' indexes of the bridge corpus, built with the learned
    encoder (d 32, stored f32)."""
    j, t, _ = encoders
    docs, questions = _bridge_corpus()
    j_idx = build_packed_index(SentenceCorpus(docs=docs), encoder=j,
                               embed_dtype="float32", embed_batch=32)
    t_idx = t_build(TCorpus(docs=list(docs)), encoder=t,
                    embed_dtype="float32", embed_batch=32)
    return j_idx, t_idx, questions


def test_sidecar_bits_equal_jax():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((40, 24)).astype(np.float32)
    emb[0, :4] = [0.0, -0.0, 1.0, 3.3895314e38]  # signed zero, near the top
    # round-to-nearest-even ties: exactly halfway between two bf16 values
    emb[1, :2] = np.array([0x3F808000, 0x3F818000],
                          dtype=np.uint32).view(np.float32)
    np.testing.assert_array_equal(t_packed.bf16_bits(emb),
                                  j_re._bf16_bits(emb))
    np.testing.assert_array_equal(
        t_packed.bf16_bits(emb),
        torch.from_numpy(emb).to(torch.bfloat16).view(torch.int16).numpy()
        .view(np.uint16))


def test_embed_corpus_pipelined_matches_jax(encoders):
    j, t, _ = encoders
    docs, _ = _bridge_corpus()
    texts = [d["text"] for d in docs]
    a = j_re.embed_corpus_pipelined(j, texts, batch=32)  # padded tail
    b = t_re.embed_corpus_pipelined(t, texts, batch=32)
    assert b.shape == (len(texts), 32) and b.dtype == np.float32
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
    np.testing.assert_allclose(b, t.encode_texts(texts), atol=1e-6, rtol=0)
    assert t_re.embed_corpus_pipelined(t, [], batch=8).shape == (0, 32)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sidecar_attaches_in_the_other_package(encoders, learned, writer,
                                               tmp_path):
    j, t, ckpt = encoders
    j_idx, t_idx, questions = learned
    cache = tmp_path / "caches" / "idx"
    t_idx.save(cache)
    emb = np.asarray(t_idx.embeddings, dtype=np.float32)
    save = (t_re if writer == "port" else j_re).save_learned_embeddings
    doc = save(cache, emb, ckpt, t.cfg if writer == "port" else j.cfg,
               extra={"note": "x"})
    assert doc["rows"] == t_idx.n_docs and doc["dim"] == 32
    assert doc["note"] == "x" and len(doc["encoder_sha256"]) == 64
    on_disk = json.loads((cache / "learned_embed.json").read_text())
    assert on_disk["encoder_config"] == ENC | {"ngram_min": 3, "ngram_max": 5}
    np.testing.assert_array_equal(np.load(cache / "embeddings_learned.npy"),
                                  t_packed.bf16_bits(emb))

    # the other package attaches it: bf16 rows, and a query encoder that
    # embeds like the one the corpus was embedded with
    if writer == "port":
        idx = PackedIndex.load(cache)
        enc, got = j_re.attach_learned_embeddings(idx, cache)
    else:
        idx = TIndex.load(cache)
        enc, got = t_re.attach_learned_embeddings(idx, cache, device="cpu")
        assert enc.device == torch.device("cpu")
    assert got["rows"] == doc["rows"] and idx.embed_dtype == "bfloat16"
    assert idx.embeddings.dtype == np.uint16
    np.testing.assert_array_equal(np.asarray(idx.embeddings),
                                  t_packed.bf16_bits(emb))
    # the sidecar's config carries no dtype: the default bf16 compute
    np.testing.assert_allclose(enc.encode_texts(questions[:6]),
                               t.encode_texts(questions[:6]), atol=2e-2)
    # the port's engine over the attached index answers dense queries
    if writer == "jax":
        eng = TorchQueryEngine(idx, device="cpu", encoder=enc,
                               config=TConfig(top_k=5, batch_buckets=(8,)))
        r = eng.query_dense_batch(questions[:6])
        assert r.hits.ids.shape == (6, 5) and np.isfinite(r.hits.scores).all()
    # no sidecar, or one for another row count: None
    assert t_re.attach_learned_embeddings(idx, tmp_path, device="cpu") is None
    np.save(cache / "embeddings_learned.npy", t_packed.bf16_bits(emb[:-1]))
    assert t_re.attach_learned_embeddings(TIndex.load(cache), cache,
                                          device="cpu") is None


def test_build_packed_index_with_text_encoder_equals_jax(learned):
    j_idx, t_idx, _ = learned
    assert t_idx.embed_dim == j_idx.embed_dim == 32
    np.testing.assert_allclose(np.asarray(t_idx.embeddings),
                               np.asarray(j_idx.embeddings), atol=ATOL,
                               rtol=0)
    for f in ("doc_ids", "tfs", "row_ptr", "df", "doc_lens"):
        np.testing.assert_array_equal(getattr(t_idx.bm25, f),
                                      getattr(j_idx.bm25, f), err_msg=f)
    np.testing.assert_array_equal(t_idx.graph_next, j_idx.graph_next)
    np.testing.assert_array_equal(t_idx.graph_entity, j_idx.graph_entity)


def _engines(encoders, learned, **over):
    j, t, _ = encoders
    j_idx, t_idx, questions = learned
    kw = dict(CFG, **over)
    return (TPUQueryEngine(j_idx, encoder=j, config=EngineConfig(**kw)),
            TorchQueryEngine(t_idx, device="cpu", encoder=t,
                             config=TConfig(**kw)), questions)


@pytest.mark.parametrize("graph_impl", ["auto", "compact"])
def test_engine_with_learned_encoder_matches_jax(encoders, learned,
                                                 graph_impl):
    j_eng, t_eng, qs = _engines(encoders, learned, graph_impl=graph_impl)
    r_j = j_eng.query_batch(qs, top_k=10)
    r_t = t_eng.query_batch(qs, top_k=10)
    np.testing.assert_array_equal(r_t.hits.ids, np.asarray(r_j.hits.ids))
    np.testing.assert_allclose(r_t.hits.scores, np.asarray(r_j.hits.scores),
                               atol=ATOL)
    np.testing.assert_allclose(r_t.channel_norms,
                               np.asarray(r_j.channel_norms), atol=ATOL)
    # the dense channel is live: its norms are not all zero
    assert np.abs(r_t.channel_norms[2]).max() > 0.5
    # every entry point goes through the same fused seam
    np.testing.assert_array_equal(
        t_eng.query_batch_async(qs, top_k=10).result().hits.ids, r_t.hits.ids)
    piped = list(t_eng.query_batches_pipelined([qs[:8], qs[8:]], top_k=10))
    t_eng.close()
    np.testing.assert_array_equal(
        np.concatenate([r.hits.ids for r in piped]), r_t.hits.ids)

    d_j = j_eng.query_dense_batch(qs, top_k=5)
    d_t = t_eng.query_dense_batch(qs, top_k=5)
    np.testing.assert_array_equal(d_t.hits.ids, np.asarray(d_j.hits.ids))
    np.testing.assert_allclose(d_t.hits.scores, np.asarray(d_j.hits.scores),
                               atol=ATOL)


def test_iterative_and_server_with_learned_encoder_match_jax(encoders,
                                                             learned):
    j_eng, t_eng, qs = _engines(encoders, learned)
    want = jmh.iterative_retrieve(j_eng, qs, top_k=10)
    got = tmh.iterative_retrieve(t_eng, qs, top_k=10)
    _assert_same_iterative(got, want)
    assert got[3]["hop2_active"] > 0
    piped = list(tmh.iterative_retrieve_pipelined(t_eng, [qs[:8], qs[8:]],
                                                  top_k=10))
    np.testing.assert_array_equal(
        np.concatenate([p[0] for p in piped]), got[0])
    corpus = t_eng.index.corpus
    with QueryServer(t_eng, max_batch=8, max_wait_ms=10) as server:
        single = server.submit_many(qs[:8], top_k=10)
        it = server.submit_many(qs[:8], mode="iterative", top_k=10)
        direct = t_eng.query_batch(qs[:8], top_k=10)
        for row, hits in enumerate(single.result(120)):
            assert [h.id for h in hits] == [
                corpus.hit_id(int(i)) for i in direct.hits.ids[row] if i >= 0]
        for row, hits in enumerate(it.result(120)):
            assert [h.id for h in hits] == [
                corpus.hit_id(int(i)) for i in got[0][row] if i >= 0]
    t_eng.close()


def test_engine_rejects_an_encoder_on_another_device(learned):
    _, t_idx, _ = learned

    class Elsewhere:
        device = torch.device("meta")
        dim = 32

    with pytest.raises(ValueError, match="encoder's parameters are on"):
        TorchQueryEngine(t_idx, device="cpu", encoder=Elsewhere())
