"""Semantic edges: the port's `ops.semantic` vs the JAX package's.

The same embeddings (numpy, from a seed) go through both `semantic_edges`:
the edge lists (i, j) must be identical and the similarities within 1e-6
(both compute f32 cosines; they differ by summation order only). Random
embeddings sit far from the threshold; the near-duplicate ones sit well
inside it (cosine ~0.999 against a 0.9 cut), so no pair straddles the cut.
"""
import numpy as np
import pytest
import torch

from a_modular_rag_framework_torch.ops.semantic import (semantic_edges,
                                                        semantic_sim_matrix)
from a_modular_rag_framework_tpu.ops import semantic as j_sem

ATOL = 1e-6


def _random(n, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _near_duplicates(n, d=16, seed=1):
    """Groups of three near-copies of a base direction, plus a zero row."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(((n + 2) // 3, d)).astype(np.float32)
    emb = np.repeat(base, 3, axis=0)[:n]
    emb = emb + 0.01 * rng.standard_normal(emb.shape).astype(np.float32)
    if n:
        emb[-1] = 0.0
    return emb.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "near_duplicates"])
@pytest.mark.parametrize("top_k", [0, 2])
@pytest.mark.parametrize("n", [0, 1, 2, 17, 64])
def test_semantic_edges_match_jax(n, top_k, kind):
    emb = (_random if kind == "random" else _near_duplicates)(n)
    threshold = 0.2 if kind == "random" else 0.9
    got = semantic_edges(emb, threshold=threshold, top_k_per_node=top_k,
                         device="cpu")
    want = j_sem.semantic_edges(emb, threshold=threshold, top_k_per_node=top_k)
    assert [(i, j) for i, j, _ in got] == [(i, j) for i, j, _ in want]
    np.testing.assert_allclose([s for *_, s in got], [s for *_, s in want],
                               atol=ATOL)
    if kind == "near_duplicates" and n >= 17 and not top_k:
        assert len(got) >= n // 3  # the groups are found


def test_duplicate_sentences_get_an_edge():
    """`tests/test_ops.py`'s first case: two equal rows, one unrelated."""
    emb = np.array([[1, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=np.float32)
    edges = semantic_edges(emb, threshold=0.9, device="cpu")
    assert [(i, j) for i, j, _ in edges] == [(0, 1)]
    assert edges[0][2] == pytest.approx(1.0, abs=ATOL)


def test_top_k_per_node_keeps_the_strongest_partner():
    """`tests/test_ops.py`'s second case: per-row sparsification."""
    emb = np.array([[1.0, 0.0], [0.99, 0.14], [0.9, 0.43], [0.0, 1.0]],
                   dtype=np.float32)
    S = semantic_sim_matrix(torch.from_numpy(emb), threshold=0.5,
                            top_k_per_node=1).numpy()
    J = np.asarray(j_sem.semantic_sim_matrix(emb, threshold=0.5,
                                             top_k_per_node=1))
    np.testing.assert_allclose(S, J, atol=ATOL)
    assert ((S > 0).sum(axis=1) <= 1).all() and S[0, 1] > 0 and S[0, 2] == 0


def test_matches_float64_numpy_and_ignores_matmul_precision():
    emb = _near_duplicates(64, d=64, seed=3)
    e64 = emb.astype(np.float64)
    norms = np.linalg.norm(e64, axis=1, keepdims=True)
    en = e64 / np.maximum(norms, 1e-9)
    ref = en @ en.T
    keep = (ref >= 0.9) & ~np.eye(64, dtype=bool)
    keep &= (norms[:, 0] > 1e-9)[:, None] & (norms[:, 0] > 1e-9)[None, :]
    before = torch.get_float32_matmul_precision()
    S = semantic_sim_matrix(torch.from_numpy(emb), threshold=0.9).numpy()
    assert torch.get_float32_matmul_precision() == before
    assert ((S > 0) == keep).all()
    np.testing.assert_allclose(S[keep], ref[keep], atol=ATOL)


def test_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        semantic_edges(_random(4), threshold=0.5)
