"""Port's fused dense top-k vs the JAX package's.

The port's plain version (`dense_topk_reference`) is held against
`dense_topk_pallas` in interpret mode (as tests/test_ops.py runs it) and
against `dense_topk_xla(precision=HIGHEST)`, on the same numpy inputs.
Ids must be identical (tie order included); scores agree to rtol 1e-5
(both sides are exact-f32 dot products summed in different orders).
The kernel's f32-faithful arithmetic (the exact bf16 split and the
plane-product sum) is held here in plain torch; the CUDA kernel itself is
checked on the card (`gpu` marker here, and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import SCORE_ATOL
from a_modular_rag_framework_torch.ops import topk as ttopk
from a_modular_rag_framework_tpu.ops.topk import dense_topk_pallas, dense_topk_xla

HIGHEST = jax.lax.Precision.HIGHEST


def _jax_pallas(q, d, k, tile_n, **kw):
    with pltpu.force_tpu_interpret_mode():
        s, i = dense_topk_pallas(jnp.asarray(q), jnp.asarray(d), k,
                                 tile_n=tile_n, precision=HIGHEST, **kw)
    return np.asarray(s), np.asarray(i)


def _jax_xla(q, d, k):
    s, i = dense_topk_xla(jnp.asarray(q), jnp.asarray(d), k, precision=HIGHEST)
    return np.asarray(s), np.asarray(i)


def _port(q, d, k):
    s, i = ttopk.dense_topk_reference(torch.from_numpy(q), torch.from_numpy(d), k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy()


def _check(port, ref, rtol=1e-5, atol=0.0):
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_allclose(port[0], ref[0], rtol=rtol, atol=atol)


def test_reference_matches_pallas_and_xla(rng):
    q = rng.standard_normal((4, 32), dtype=np.float32)
    d = rng.standard_normal((300, 32), dtype=np.float32)  # pads to 3 tiles
    got = _port(q, d, 8)
    _check(got, _jax_pallas(q, d, 8, tile_n=128))
    _check(got, _jax_xla(q, d, 8))


def test_reference_all_negative_scores(rng):
    """Every real score negative: the JAX kernel's padded rows must not win,
    and the port reads no padding at all."""
    q = np.abs(rng.standard_normal((3, 16), dtype=np.float32))
    d = -np.abs(rng.standard_normal((100, 16), dtype=np.float32))
    got = _port(q, d, 7)
    assert (got[0] < 0).all()
    _check(got, _jax_pallas(q, d, 7, tile_n=128))
    _check(got, _jax_xla(q, d, 7))


def test_reference_bf16_storage(rng):
    """bf16 corpus, f32 accumulation: both sides upcast the same bf16 bits."""
    q = rng.standard_normal((2, 16), dtype=np.float32)
    d32 = rng.standard_normal((128, 16), dtype=np.float32)
    d_bf = torch.from_numpy(d32).to(torch.bfloat16)
    s, i = ttopk.dense_topk_reference(torch.from_numpy(q), d_bf, 5)
    with pltpu.force_tpu_interpret_mode():
        s_p, i_p = dense_topk_pallas(jnp.asarray(q),
                                     jnp.asarray(d32).astype(jnp.bfloat16), 5,
                                     tile_n=64)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_p))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_p), rtol=1e-5)
    # the bf16 values themselves are identical in both frameworks
    np.testing.assert_array_equal(
        d_bf.float().numpy(),
        np.asarray(jnp.asarray(d32).astype(jnp.bfloat16).astype(jnp.float32)))


def test_reference_adversarial_ascending():
    """Ascending scores: every tile improves every row."""
    q = np.ones((4, 8), np.float32)
    d = (np.linspace(0, 1, 512, dtype=np.float32)[:, None]
         * np.ones((512, 8), np.float32))
    _check(_port(q, d, 10), _jax_pallas(q, d, 10, tile_n=128))


@pytest.mark.parametrize("k", [1, 12, 40])
def test_reference_tie_order_matches_lax_topk(rng, k):
    """Duplicated rows with small-integer values (every score exact in any
    summation order): equal scores keep ascending ids, lax.top_k's order."""
    d = np.repeat(rng.integers(-4, 5, size=(50, 8)).astype(np.float32), 4,
                  axis=0)
    q = rng.integers(-3, 4, size=(3, 8)).astype(np.float32)
    got = _port(q, d, k)
    _check(got, _jax_pallas(q, d, k, tile_n=64))
    _check(got, _jax_xla(q, d, k))


@pytest.mark.parametrize("B,N,k,tn", [(8, 700, 33, 128), (16, 256, 5, 64),
                                      (2, 2000, 200, 512), (5, 130, 130, 64)])
def test_reference_shape_fuzz(rng, B, N, k, tn):
    """k above 128 lanes, k == N, batch remainder, odd corpus sizes."""
    q = rng.standard_normal((B, 24)).astype(np.float32)
    d = rng.standard_normal((N, 24)).astype(np.float32)
    got = _port(q, d, k)
    _check(got, _jax_pallas(q, d, k, tile_n=tn, tile_b=8), rtol=1e-4,
           atol=1e-5)
    _check(got, _jax_xla(q, d, k), rtol=1e-4, atol=1e-5)


def test_reference_raises_when_k_exceeds_n(rng):
    q = torch.zeros((1, 4))
    with pytest.raises(ValueError):
        ttopk.dense_topk_reference(q, torch.zeros((3, 4)), 4)


def test_stable_topk_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0]])
    vals, idx = ttopk.stable_topk(x, 4, dim=1)
    assert idx.tolist() == [[1, 2, 4, 5]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]


def test_dispatch_on_cpu_uses_reference_and_counts_no_launch(rng):
    q = torch.from_numpy(rng.standard_normal((3, 8), dtype=np.float32))
    d = torch.from_numpy(rng.standard_normal((40, 8), dtype=np.float32))
    before = ttopk.dense_topk_cuda.launches
    s, i = ttopk.dense_topk(q, d, 5)
    s_ref, i_ref = ttopk.dense_topk_reference(q, d, 5)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)
    assert ttopk.dense_topk_cuda.launches == before


def test_cuda_wrapper_raises_on_cpu_tensors(rng):
    """No fallback: the kernel's wrapper refuses anything but CUDA tensors,
    and touches neither the compiler nor the launch count."""
    q = torch.zeros((2, 8))
    d = torch.zeros((16, 8))
    before = ttopk.dense_topk_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ttopk.dense_topk_cuda(q, d, 3)
    assert ttopk.dense_topk_cuda.launches == before


# ---------------- the kernel's arithmetic, in plain torch ----------------


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4])
def test_split_bf16x3_is_exact(rng, scale):
    """hi + mid + lo == x exactly (summed in f64), each plane bf16."""
    x = torch.from_numpy(
        (rng.standard_normal((64, 48)) * scale).astype(np.float32))
    planes = ttopk.split_bf16x3(x)
    assert planes.shape == (3, 64, 48) and planes.dtype == torch.bfloat16
    total = planes.double().sum(dim=0)
    assert torch.equal(total, x.double())
    assert torch.equal(planes[0], x.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plane_scores_equal_reference(rng, dtype):
    """The plane-product sum the kernel forms: bit-exact on integer inputs
    (ids too, ties included), within 1e-6 of the f32 product on random
    unit vectors, with the same ids on those tie-free inputs."""
    qi = torch.from_numpy(rng.integers(-3, 4, (9, 40)).astype(np.float32))
    di = torch.from_numpy(np.repeat(
        rng.integers(-4, 5, (60, 40)).astype(np.float32), 4, axis=0)).to(dtype)
    s = ttopk.bf16x3_scores(qi, di)
    assert torch.equal(s, qi @ di.float().T)
    vals, ids = ttopk.stable_topk(s, 30, dim=1)
    s_ref, i_ref = ttopk.dense_topk_reference(qi, di, 30)
    assert torch.equal(ids.to(torch.int32), i_ref) and torch.equal(vals, s_ref)

    def unit(a):
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    q = torch.from_numpy(unit(rng.standard_normal((16, 64))).astype(np.float32))
    d = torch.from_numpy(
        unit(rng.standard_normal((500, 64))).astype(np.float32)).to(dtype)
    s = ttopk.bf16x3_scores(q, d)
    ref = q.double() @ d.double().T
    assert float((s.double() - ref).abs().max()) < 1e-6
    _, ids = ttopk.stable_topk(s, 10, dim=1)
    _, i_ref = ttopk.dense_topk_reference(q, d, 10)
    assert torch.equal(ids.to(torch.int32), i_ref)


@pytest.mark.parametrize("dim,k,dpad,nwg,smem_lists", [
    (16, 10, 16, 2, True), (33, 10, 48, 2, True), (64, 10, 64, 2, True),
    (64, 100, 64, 1, True), (64, 256, 64, 1, True), (128, 10, 128, 2, True),
    (128, 100, 128, 1, True), (130, 10, 144, 1, True),
    (130, 256, 144, 1, False), (256, 100, 256, 1, True)])
def test_kernel_widths_and_layout(dim, k, dpad, nwg, smem_lists):
    """The wrapper pads the width to a multiple of 16 (none at 64); the
    kernel holds 128 query rows per block up to d 128 and keeps the
    running lists in shared memory where they fit (a block's 227 KB),
    giving up the second warpgroup for them before it gives them up."""
    assert ttopk._padded_dim(dim) == dpad
    assert ttopk._layout(dim, k) == (nwg, smem_lists)
    assert ttopk._partial_smem(nwg, dpad, k, smem_lists) <= ttopk._MAX_SMEM


# ---------------- on the card ----------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,d,k", [(3, 100, 16, 7), (70, 1000, 64, 1),
                                     (5, 3000, 33, 256), (64, 5000, 130, 100),
                                     (130, 4099, 64, 10), (9, 777, 16, 256)])
def test_cuda_kernel_matches_reference(cuda_device, dtype, B, N, d, k):
    """Small-integer inputs: every score is exact, so ids (tie order
    included) and scores must be identical to the plain version. N is not
    a multiple of the 128-row tile in most cases."""
    g = np.random.default_rng(B * 7 + N)
    q = torch.from_numpy(g.integers(-3, 4, (B, d)).astype(np.float32))
    db = torch.from_numpy(g.integers(-4, 5, (N, d)).astype(np.float32))
    q, db = q.to(cuda_device), db.to(cuda_device, dtype)
    before = ttopk.dense_topk_cuda.launches
    s, i = ttopk.dense_topk_cuda(q, db, k)
    torch.cuda.synchronize()
    assert ttopk.dense_topk_cuda.launches == before + 1
    s_ref, i_ref = ttopk.dense_topk_reference(q, db, k)
    assert torch.equal(i.cpu(), i_ref.cpu())
    assert torch.equal(s.cpu(), s_ref.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 33, 64, 128, 130])
@pytest.mark.parametrize("k", [1, 10, 100, 256])
def test_cuda_kernel_widths_and_k(cuda_device, dtype, d, k):
    """4x duplicated integer rows (exact ties: the order must be lax.top_k's)
    at every width and k, N not a multiple of the tile."""
    g = np.random.default_rng(d * 1000 + k)
    base = g.integers(-4, 5, (301, d)).astype(np.float32)
    db = torch.from_numpy(np.repeat(base, 4, axis=0)).to(cuda_device, dtype)
    q = torch.from_numpy(g.integers(-3, 4, (37, d)).astype(
        np.float32)).to(cuda_device)
    s, i = ttopk.dense_topk_cuda(q, db, k)
    s_ref, i_ref = ttopk.dense_topk_reference(q, db, k)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_all_negative_and_random(cuda_device, dtype):
    """All-negative scores (the zero-filled rows past N must never win),
    then random unit vectors: scores within SCORE_ATOL of the f32 product
    (|score| up to ~20 here, summed in another order), ids equal
    (tie-free inputs)."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    q = torch.rand((9, 64), generator=g, device=cuda_device) + 0.1
    db = (-(torch.rand((777, 64), generator=g, device=cuda_device)
            + 0.1)).to(dtype)
    s, i = ttopk.dense_topk_cuda(q, db, 13)
    s_ref, i_ref = ttopk.dense_topk_reference(q, db, 13)
    assert (s < 0).all() and torch.equal(i, i_ref)
    torch.testing.assert_close(s, s_ref, rtol=0, atol=SCORE_ATOL)
    q = torch.nn.functional.normalize(
        torch.randn((200, 64), generator=g, device=cuda_device), dim=1)
    db = torch.nn.functional.normalize(
        torch.randn((20000, 64), generator=g, device=cuda_device),
        dim=1).to(dtype)
    s, i = ttopk.dense_topk_cuda(q, db, 50)
    s_ref, i_ref = ttopk.dense_topk_reference(q, db, 50)
    assert torch.equal(i, i_ref)
    torch.testing.assert_close(s, s_ref, rtol=0, atol=SCORE_ATOL)
