"""Port's fused dense top-k vs the JAX package's.

The port's plain version (`dense_topk_reference`) is held against
`dense_topk_pallas` in interpret mode (as tests/test_ops.py runs it) and
against `dense_topk_xla(precision=HIGHEST)`, on the same numpy inputs.
Ids must be identical (tie order included); scores agree to rtol 1e-5
(both sides are exact-f32 dot products summed in different orders).
The CUDA kernel itself is checked on the card (`gpu` marker here, and
chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

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


# ---------------- on the card ----------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,d,k", [(3, 100, 16, 7), (70, 1000, 64, 1),
                                     (5, 3000, 33, 256), (64, 5000, 130, 100)])
def test_cuda_kernel_matches_reference(cuda_device, dtype, B, N, d, k):
    """Small-integer inputs: every score is exact, so ids (tie order
    included) and scores must be identical to the plain version."""
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
