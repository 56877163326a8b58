"""B1 (``ops/topk.py``, ``csrc/dense_topk.cu``) beyond d 256, where the
query planes stream through the ring beside the corpus (an LLM embedder's
d 2048), and its launch at d <= 256 (the hash and learned cells' d 64 and
128) kept as it was. On the card (``gpu``) the kernel is held against the
plain version bit for bit on integer inputs. This file imports no JAX."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from a_modular_rag_framework_torch.ops import topk as ttopk


class _Props:
    multi_processor_count = 132


@pytest.fixture()
def h100_sms(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())


@pytest.mark.parametrize("dim,k,dpad,smem_lists", [
    (257, 10, 272, True), (512, 10, 512, True), (1000, 10, 1008, True),
    (2048, 10, 2048, True), (2048, 100, 2048, True), (2048, 256, 2048, False)])
def test_layout_where_the_query_planes_stream(dim, k, dpad, smem_lists):
    """Beyond d 256 the planes stream: one 64-row warpgroup a block, three
    ring stages of chunks whatever the width."""
    assert ttopk._padded_dim(dim) == dpad and ttopk._streams(dpad)
    assert ttopk._layout(dim, k) == (1, smem_lists)
    assert ttopk._partial_smem(1, dpad, k, smem_lists) <= ttopk._MAX_SMEM
    assert ttopk._partial_smem(1, dpad, k, False) == ttopk._partial_smem(
        1, 512, k, False)
    assert ttopk.MAX_DIM == 2048


def _parent_splits(B, N, nwg, sms):
    """`_splits` as it was before the planes could stream (d <= 256)."""
    q_tiles = -(-B // (64 * nwg))
    tiles = -(-N // 128)
    want = max(1, min(sms // q_tiles, tiles, 1024))
    slice_ = -(-tiles // want) * 128
    return -(-N // slice_), slice_


@pytest.mark.parametrize("B", [1, 70, 4096, 8192])
@pytest.mark.parametrize("N", [100, 258500, 1034000])
@pytest.mark.parametrize("dim,k", [(64, 10), (128, 10), (128, 100),
                                   (256, 10)])
def test_launch_parameters_unchanged_up_to_d256(h100_sms, B, N, dim, k):
    """At d <= 256 the planes stay resident and the splits are the
    parent's: the same instance with the same launch, so the same bits."""
    nwg, _ = ttopk._layout(dim, k)
    assert not ttopk._streams(ttopk._padded_dim(dim))
    assert ttopk._splits(B, N, nwg, "cuda") == _parent_splits(B, N, nwg,
                                                              132)


def test_streamed_splits_keep_few_query_tiles_resident(h100_sms):
    """B 4096 (64 query tiles): 16 splits, so the 132 resident blocks hold
    about 8 query tiles; one query tile takes about a split per SM."""
    S, slice_ = ttopk._splits(4096, 259097, 1, "cuda", stream=True)
    assert S == 16 and slice_ % 128 == 0 and (S - 1) * slice_ < 259097
    assert 120 <= ttopk._splits(64, 259097, 1, "cuda", stream=True)[0] <= 132


# ---------------- on the card ----------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [512, 1000, 1024, 2048])
@pytest.mark.parametrize("B,N,k", [(70, 3001, 10), (200, 1000, 256)])
def test_streamed_planes_match_reference(cuda_device, dtype, d, B, N, k):
    """Small-integer inputs (every score exact), rows duplicated for exact
    ties: ids and scores equal the plain version bit for bit."""
    g = np.random.default_rng(d + B)
    base = g.integers(-4, 5, (-(-N // 2), d)).astype(np.float32)
    db = torch.from_numpy(np.repeat(base, 2, axis=0)[:N]).to(cuda_device,
                                                            dtype)
    q = torch.from_numpy(g.integers(-3, 4, (B, d)).astype(
        np.float32)).to(cuda_device)
    s, i = ttopk.dense_topk_cuda(q, db, k)
    s_ref, i_ref = ttopk.dense_topk_reference(q, db, k)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_d64_d128_at_the_main_shape(cuda_device, d):
    """The cells' widths at B 4096 through the parent's launch: exact on
    integer inputs, repeatable bit for bit on unit vectors."""
    g = np.random.default_rng(d)
    db = torch.from_numpy(g.integers(-4, 5, (30001, d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    q = torch.from_numpy(g.integers(-3, 4, (4096, d)).astype(
        np.float32)).to(cuda_device)
    s, i = ttopk.dense_topk_cuda(q, db, 10)
    s_ref, i_ref = ttopk.dense_topk_reference(q, db, 10)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)
    q = torch.nn.functional.normalize(torch.randn(
        (4096, d), device=cuda_device), dim=1)
    a = ttopk.dense_topk_cuda(q, db, 10)
    b = ttopk.dense_topk_cuda(q, db, 10)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
