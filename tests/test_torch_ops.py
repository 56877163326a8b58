"""Port's device ops (plain torch) vs the JAX package's, same numpy inputs.

Tolerances: BM25 phase-1 run totals are differences of f32 prefix sums
over up to T*term_topm = 32k postings, taken in each framework's own
order (JAX's sort is not stable), so they carry an error of a few ulps of
the row's mass (~1e2 here): scores are held to atol 5e-5, and ids must be
equal on these tie-free inputs.
The re-score, graph expansion, fusion and hash embedding do the same f32
operations in the same order and are held to atol 1e-6 (exact in
practice); the dense graph forms are max/multiply only and are held bit
for bit, bf16 waves included. The scatter BM25 adds each doc's
contributions in another order and is held to atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_modular_rag_framework_torch.models import hash_embed as t_hash
from a_modular_rag_framework_torch.ops import bm25 as t_bm25
from a_modular_rag_framework_torch.ops import fusion as t_fusion
from a_modular_rag_framework_torch.ops import graph as t_graph
from a_modular_rag_framework_tpu.models.hash_embed import HashEmbedEncoder
from a_modular_rag_framework_tpu.models.hash_embed import \
    hash_embed_numpy as j_hash_embed_numpy
from a_modular_rag_framework_tpu.ops import bm25 as j_bm25
from a_modular_rag_framework_tpu.ops import fusion as j_fusion
from a_modular_rag_framework_tpu.ops import graph as j_graph
from a_modular_rag_framework_tpu.parallel.sharded_hybrid import _tie_free_corpus


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def bm25_index():
    """A real posting layout with random, distinct per-posting
    contributions (still sorted descending within each term): real BM25
    contributions tie exactly across equal-length docs, and f32 run sums
    taken in another order would then break those ties differently."""
    corpus, _ = _tie_free_corpus(n_docs=60, seed=5)
    idx = j_bm25.Bm25DeviceIndex.build(corpus.texts(), use_native=False)
    rng = np.random.default_rng(11)
    scores = rng.uniform(0.05, 3.0, size=idx.doc_ids.shape).astype(np.float32)
    for t in range(len(idx.df)):
        s, e = idx.row_ptr[t], idx.row_ptr[t + 1]
        order = np.argsort(-scores[s:e], kind="stable")
        scores[s:e] = scores[s:e][order]
        idx.doc_ids[s:e] = idx.doc_ids[s:e][order]
    idx.scores = scores
    return idx


def _term_ids(rng, V, B, E, T_, dup=True):
    ids = rng.integers(0, V, size=(B, E, T_)).astype(np.int32)
    lengths = rng.integers(1, T_ + 1, size=(B, E))
    for b in range(B):
        for e in range(E):
            ids[b, e, lengths[b, e]:] = -1
            if dup and lengths[b, e] >= 2:
                ids[b, e, 1] = ids[b, e, 0]  # duplicate terms count twice
    return ids


@pytest.mark.parametrize("E", [1, 4])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("term_topm,pool_k", [(4096, 40), (3, 16)])
def test_bm25_topk_sorted_matches_jax(bm25_index, E, packed, term_topm,
                                      pool_k):
    idx = bm25_index
    rng = np.random.default_rng(E * 10 + packed + term_topm)
    term_ids = _term_ids(rng, len(idx.vocab), 6, E, 8)
    dev = idx.device_arrays()
    j_s, j_i = j_bm25.bm25_topk_sorted(
        jnp.asarray(term_ids), dev["doc_ids"], dev["scores"], dev["row_ptr"],
        n_docs=idx.n_docs, term_topm=term_topm, pool_k=pool_k,
        posting_packed=dev["posting_packed"] if packed else None)
    packed_t = T(np.asarray(dev["posting_packed"])) if packed else None
    t_s, t_i = t_bm25.bm25_topk_sorted(
        T(term_ids), T(idx.doc_ids), T(idx.scores), T(idx.row_ptr),
        n_docs=idx.n_docs, term_topm=term_topm, pool_k=pool_k,
        posting_packed=packed_t)
    assert t_i.dtype == torch.int32 and t_s.dtype == torch.float32
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), atol=5e-5)


def test_bm25_topk_sorted_term_weights_seam(bm25_index):
    idx = bm25_index
    rng = np.random.default_rng(3)
    term_ids = _term_ids(rng, len(idx.vocab), 4, 2, 8)
    w = rng.uniform(0.1, 2.0, size=term_ids.shape).astype(np.float32)
    dev = idx.device_arrays()
    j_s, j_i = j_bm25.bm25_topk_sorted(
        jnp.asarray(term_ids), dev["doc_ids"], dev["scores"], dev["row_ptr"],
        n_docs=idx.n_docs, term_topm=64, pool_k=30,
        term_weights=jnp.asarray(w))
    t_s, t_i = t_bm25.bm25_topk_sorted(
        T(term_ids), T(idx.doc_ids), T(idx.scores), T(idx.row_ptr),
        n_docs=idx.n_docs, term_topm=64, pool_k=30, term_weights=T(w))
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), atol=5e-5)


@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("doc_cap", [64, 3])
def test_bm25_rescore_pool_matches_jax(bm25_index, E, doc_cap):
    idx = bm25_index
    rng = np.random.default_rng(E + doc_cap)
    term_ids = _term_ids(rng, len(idx.vocab), 5, E, 8)
    pool = rng.integers(-1, idx.n_docs, size=(5, 24)).astype(np.int32)
    terms, scores = idx.doc_major_padded(doc_cap)
    j = j_bm25.bm25_rescore_pool(jnp.asarray(pool), jnp.asarray(term_ids),
                                 jnp.asarray(terms), jnp.asarray(scores),
                                 n_docs=idx.n_docs)
    t = t_bm25.bm25_rescore_pool(T(pool), T(term_ids), T(terms), T(scores),
                                 n_docs=idx.n_docs)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def _neighbors(rng, n, n_edges, deg):
    src = rng.integers(0, n, size=n_edges)
    dst = rng.integers(0, n, size=n_edges)
    keep = src != dst
    return j_graph.build_neighbor_table(n, src[keep], dst[keep],
                                        max_degree=deg)


@pytest.mark.parametrize("window", [0, 1, 2])
@pytest.mark.parametrize("cap,out_k", [(64, 64), (3, 40)])
@pytest.mark.parametrize("uniform", [False, True])
def test_expand_frontier_compact_matches_jax(window, cap, out_k, uniform):
    """cap=3 truncates the propagating wave; uniform seeds give large exact
    tie groups, which must resolve in the same (ascending id) order."""
    rng = np.random.default_rng(window * 100 + cap)
    n = 120
    nbrs = _neighbors(rng, n, 260, 6)
    seed_ids = rng.integers(-1, n, size=(4, 7)).astype(np.int32)
    seed_vals = (np.ones((4, 7), np.float32) if uniform
                 else rng.uniform(0.05, 1.0, size=(4, 7)).astype(np.float32))
    j_s, j_i = j_graph.expand_frontier_weighted_compact(
        jnp.asarray(nbrs), jnp.asarray(seed_ids), jnp.asarray(seed_vals),
        window=window, cap=cap, out_k=out_k)
    t_s, t_i = t_graph.expand_frontier_weighted_compact(
        T(nbrs), T(seed_ids), T(seed_vals), window=window, cap=cap,
        out_k=out_k)
    assert t_i.dtype == torch.int32
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), atol=1e-6)


def _seed_scores(rng, B, n, dtype_noise=True):
    """[B, n] seed strengths: ~10 seeds per row, some negative (clamped
    to 0 by every form), values off the bf16 grid."""
    s = np.zeros((B, n), np.float32)
    for b in range(B):
        rows = rng.choice(n, 10, replace=False)
        s[b, rows] = rng.uniform(-0.2, 1.0, 10).astype(np.float32)
    return s


@pytest.mark.parametrize("window", [0, 1, 2, 3])
@pytest.mark.parametrize("frontier_cap", [None, 4])
def test_expand_frontier_matches_jax(window, frontier_cap):
    """Boolean hop-decay BFS, dense hop and capped hop: the JAX per-row
    function vmapped over the batch, the port on the [B, N] batch."""
    rng = np.random.default_rng(window * 10 + (frontier_cap or 0))
    n = 90
    nbrs = _neighbors(rng, n, 200, 6)
    mask = _seed_scores(rng, 5, n) > 0
    mask[3] = False  # no seeds at all
    j_s, j_d = jax.vmap(lambda m: j_graph.expand_frontier(
        jnp.asarray(nbrs), m, window=window, frontier_cap=frontier_cap))(
        jnp.asarray(mask))
    t_s, t_d = t_graph.expand_frontier(T(nbrs), T(mask), window=window,
                                       frontier_cap=frontier_cap)
    assert t_s.dtype == torch.float32 and t_d.dtype == torch.int32
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))


@pytest.mark.parametrize("window", [1, 2])
@pytest.mark.parametrize("wave_dtype", ["float32", "bfloat16"])
def test_expand_frontier_weighted_forms_bit_equal_to_jax(window, wave_dtype):
    """The vmapped (gather-all) and the batched (per-column) forms agree
    bit for bit on each side, and the port equals JAX bit for bit, in
    f32 and with bf16 waves (hop 0 keeps f32 seed precision)."""
    rng = np.random.default_rng(window + len(wave_dtype))
    n = 110
    nbrs = _neighbors(rng, n, 240, 7)
    seeds = _seed_scores(rng, 6, n)
    j_v = np.asarray(jax.vmap(lambda s: j_graph.expand_frontier_weighted(
        jnp.asarray(nbrs), s, window=window, wave_dtype=wave_dtype))(
        jnp.asarray(seeds)))
    j_b = np.asarray(j_graph.expand_frontier_weighted_batched(
        jnp.asarray(nbrs), jnp.asarray(seeds), window=window,
        wave_dtype=wave_dtype))
    t_v = t_graph.expand_frontier_weighted(T(nbrs), T(seeds), window=window,
                                           wave_dtype=wave_dtype).numpy()
    t_b = t_graph.expand_frontier_weighted_batched(
        T(nbrs), T(seeds), window=window, wave_dtype=wave_dtype).numpy()
    np.testing.assert_array_equal(j_v, j_b)
    np.testing.assert_array_equal(t_v, t_b)
    np.testing.assert_array_equal(t_v, j_v)
    # one row through the unbatched [N] form
    np.testing.assert_array_equal(t_graph.expand_frontier_weighted(
        T(nbrs), T(seeds[2]), window=window, wave_dtype=wave_dtype).numpy(),
        j_v[2])


@pytest.mark.parametrize("window", [1, 2])
@pytest.mark.parametrize("frontier_cap", [3, 256])
def test_expand_frontier_weighted_capped_matches_jax(window, frontier_cap):
    """cap 3 truncates the propagating wave (which 3 propagate depends on
    the tie order); cap 256 >= N takes the whole wave."""
    rng = np.random.default_rng(window + frontier_cap)
    n = 100
    nbrs = _neighbors(rng, n, 220, 6)
    seeds = _seed_scores(rng, 4, n)
    seeds[1, :8] = 0.5  # an exact tie group among the seeds
    j = np.asarray(jax.vmap(lambda s: j_graph.expand_frontier_weighted_capped(
        jnp.asarray(nbrs), s, window=window, frontier_cap=frontier_cap))(
        jnp.asarray(seeds)))
    t = t_graph.expand_frontier_weighted_capped(
        T(nbrs), T(seeds), window=window, frontier_cap=frontier_cap).numpy()
    np.testing.assert_array_equal(t, j)


def test_hop_decay_table_matches_jax():
    np.testing.assert_array_equal(t_graph.hop_decay_table(6),
                                  j_graph.hop_decay_table(6))


def _fusion_inputs(rng, B=4, P=12, G=10, n=50):
    pool_i = np.stack([rng.permutation(n)[:P] for _ in range(B)]).astype(np.int32)
    pool_valid = rng.random((B, P)) > 0.2
    pool_i = np.where(pool_valid, pool_i, -1).astype(np.int32)
    pool_s = np.where(pool_valid, rng.uniform(0.1, 5, (B, P)), 0).astype(np.float32)
    dense = np.where(pool_valid, rng.uniform(-1, 1, (B, P)), 0).astype(np.float32)
    # graph pool overlaps the text pool
    g_i = np.stack([np.concatenate([pool_i[b, :4], rng.permutation(n)[:G - 4]])
                    for b in range(B)]).astype(np.int32)
    g_s = rng.uniform(0.1, 1.0, (B, G)).astype(np.float32)
    g_valid = (rng.random((B, G)) > 0.1) & (g_i >= 0)
    g_i = np.where(g_valid, g_i, -1).astype(np.int32)
    eq = pool_i[:, :, None] == np.where(g_valid, g_i, -2)[:, None, :]
    t_graph_raw = np.max(np.where(eq, g_s[:, None, :], 0.0), axis=2).astype(np.float32)
    return (pool_s, pool_i, pool_valid, dense, t_graph_raw, g_s, g_i, g_valid)


@pytest.mark.parametrize("k", [5, 30])
def test_fuse_pools_compact_matches_jax(k):
    rng = np.random.default_rng(k)
    args = _fusion_inputs(rng)
    alphas = np.array([0.15, 0.7, 0.15], np.float32)
    j_s, j_i, j_n = j_fusion.fuse_pools_compact(
        *[jnp.asarray(a) for a in args], alphas=jnp.asarray(alphas), k=k, n=50)
    t_s, t_i, t_n = t_fusion.fuse_pools_compact(
        *[T(a) for a in args], alphas=T(alphas), k=k, n=50)
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), atol=1e-6)
    np.testing.assert_allclose(t_n.numpy(), np.asarray(j_n), atol=1e-6)


def test_reorder_hits_matches_jax():
    rng = np.random.default_rng(7)
    norms = rng.uniform(0, 1, (3, 3, 8)).astype(np.float32)
    ids = rng.integers(0, 100, (3, 8)).astype(np.int32)
    ids[0, 5:] = -1  # padding hits sink to the end
    s = rng.uniform(0, 1, (3, 8)).astype(np.float32)
    j = j_fusion.reorder_hits(jnp.asarray(s), jnp.asarray(ids),
                              jnp.asarray(norms), (0.4, 0.2, 0.4))
    t = t_fusion.reorder_hits(T(s), T(ids), T(norms), (0.4, 0.2, 0.4))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-6)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), atol=1e-6)


@pytest.mark.parametrize("k", [4, 25])
def test_fuse_channels_matches_jax(k):
    """The dense [C, N] fusion oracle, vmapped over a batch; row 1 has an
    empty channel, row 2 a degenerate one, row 3 fewer union members
    than k."""
    rng = np.random.default_rng(k)
    B, C, n = 4, 3, 40
    scores = rng.uniform(-1, 3, (B, C, n)).astype(np.float32)
    present = rng.random((B, C, n)) > 0.6
    present[1, 1] = False
    present[2, 2] = False
    present[2, 2, 5] = True
    present[3] = False
    present[3, 0, :3] = True
    alphas = np.array([0.15, 0.7, 0.15], np.float32)
    j_s, j_i, j_n = jax.vmap(lambda s, p: j_fusion.fuse_channels(
        s, p, jnp.asarray(alphas), k=k))(jnp.asarray(scores),
                                         jnp.asarray(present))
    t_s, t_i, t_n = t_fusion.fuse_channels(T(scores), T(present), T(alphas),
                                           k=k)
    assert t_i.dtype == torch.int32
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), atol=1e-6)
    np.testing.assert_allclose(t_n.numpy(), np.asarray(j_n), atol=1e-6)
    assert (t_i.numpy()[3, 3:] == -1).all()


def test_minmax_normalize_matches_jax():
    rng = np.random.default_rng(2)
    v = rng.uniform(-2, 2, 30).astype(np.float32)
    for present in (rng.random(30) > 0.5, np.zeros(30, bool),
                    np.eye(1, 30, 4, dtype=bool)[0]):
        np.testing.assert_allclose(
            t_fusion.minmax_normalize(T(v), T(present)).numpy(),
            np.asarray(j_fusion.minmax_normalize(jnp.asarray(v),
                                                 jnp.asarray(present))),
            atol=1e-6)


@pytest.mark.parametrize("merge", ["max", "sum"])
@pytest.mark.parametrize("E,cap", [(1, 4096), (3, 4096), (3, 2)])
def test_bm25_scores_batched_matches_jax(bm25_index, merge, E, cap):
    """Scatter BM25 into [B, N]; cap 2 cuts each posting list to its two
    strongest postings."""
    idx = bm25_index
    rng = np.random.default_rng(E + cap)
    term_ids = _term_ids(rng, len(idx.vocab), 5, E, 8)
    dev = idx.device_arrays()
    j = j_bm25.bm25_scores_batched(
        jnp.asarray(term_ids), dev["doc_ids"], dev["scores"], dev["row_ptr"],
        n_docs=idx.n_docs, cap=cap, merge=merge)
    t = t_bm25.bm25_scores_batched(
        T(term_ids), T(idx.doc_ids), T(idx.scores), T(idx.row_ptr),
        n_docs=idx.n_docs, cap=cap, merge=merge)
    assert t.shape == (5, idx.n_docs) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


@pytest.mark.parametrize("merge", ["max", "sum", "none"])
def test_bm25_scores_matches_jax(bm25_index, merge):
    """The per-query oracle that scores from term frequencies."""
    idx = bm25_index
    rng = np.random.default_rng(4)
    term_ids = _term_ids(rng, len(idx.vocab), 1, 3, 8)[0]  # [Q=3, T=8]
    j = j_bm25.bm25_scores(
        jnp.asarray(term_ids), jnp.asarray(idx.doc_ids), jnp.asarray(idx.tfs),
        jnp.asarray(idx.row_ptr), jnp.asarray(idx.df),
        jnp.asarray(idx.doc_lens), n_docs=idx.n_docs, cap=64, merge=merge)
    t = t_bm25.bm25_scores(
        T(term_ids), T(idx.doc_ids), T(idx.tfs), T(idx.row_ptr), T(idx.df),
        T(idx.doc_lens), n_docs=idx.n_docs, cap=64, merge=merge)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_minmax_rows_matches_jax():
    rng = np.random.default_rng(1)
    v = rng.uniform(-2, 2, (5, 9)).astype(np.float32)
    valid = rng.random((5, 9)) > 0.3
    valid[2] = False  # empty pool
    valid[3] = [True] + [False] * 8  # degenerate pool
    np.testing.assert_allclose(
        t_fusion.minmax_rows(T(v), T(valid)).numpy(),
        np.asarray(j_fusion.minmax_rows(jnp.asarray(v), jnp.asarray(valid))),
        atol=1e-6)


@pytest.mark.parametrize("dim", [32, 64])
def test_device_embed_matches_jax(dim):
    texts = ["Ananan Belanan was born in Veldoria.", "", "a b c a b",
             "The quick brown fox jumps over the lazy dog twice"]
    jenc = HashEmbedEncoder(dim=dim)
    buckets, signs = jenc.host_featurize(texts)
    tenc = t_hash.HashEmbedEncoder(dim=dim)
    tb, ts = tenc.host_featurize(texts)
    np.testing.assert_array_equal(tb, buckets)
    np.testing.assert_array_equal(ts, signs)
    j = np.asarray(jenc.device_embed(jnp.asarray(buckets), jnp.asarray(signs)))
    t = tenc.device_embed(T(buckets), T(signs)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)
    np.testing.assert_allclose(tenc.encode_texts(texts),
                               jenc.encode_texts(texts), atol=1e-6)
    np.testing.assert_allclose(t_hash.hash_embed_numpy(texts, dim),
                               j_hash_embed_numpy(texts, dim), atol=1e-6)
    np.testing.assert_allclose(tenc.encode_token_batch(tb, ts),
                               jenc.encode_token_batch(buckets, signs),
                               atol=1e-6)
