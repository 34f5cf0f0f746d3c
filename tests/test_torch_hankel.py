"""Parity of the port's fused randomized Hankel SVD with the JAX package.

One Gaussian sketch, drawn by JAX from ``jax.random.key(0)`` exactly as
``hankel_randomized_svd_fused`` draws it, goes to both sides (the port's
core takes omega as a tensor), so the two runs share every iterate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.ops.hankel import hankel_randomized_svd_fused as hankel_jax
from dmd_era5_tpu.snapmat.transform import delay_embed_np
from dmd_era5_tpu_torch.ops.hankel import (
    hankel_randomized_svd_fused,
    hankel_randomized_svd_fused_core,
    stacked_sketch_matrix,
)


def _decaying(rng, s=96, t=64):
    x = (
        rng.standard_normal((s, 10))
        * (np.arange(10, 0, -1) ** 2)
        @ rng.standard_normal((10, t))
    ).astype(np.float32)
    return x + 0.01 * rng.standard_normal((s, t)).astype(np.float32)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_hankel_randomized_svd_fused_parity(rng, d):
    s, t, k, n_over = 96, 64, 6, 28
    x = _decaying(rng, s, t)
    t_out = t - d + 1
    omega = np.array(  # a writable copy for torch.from_numpy
        jax.random.normal(jax.random.key(0), (t_out, k + n_over), dtype=jnp.float32)
    )
    res_j = hankel_jax(jnp.asarray(x), d, k, gemm_dtype=jnp.float32, seed=0)
    res_t = hankel_randomized_svd_fused_core(
        torch.from_numpy(x), d, k, torch.from_numpy(omega), gemm_dtype=torch.float32
    )
    u, sv, v = (r.numpy() for r in res_t)
    assert u.shape == (d * s, k) and v.shape == (k, t_out)
    # test_08_kernels.py:147-153; the v-based flip fixes the signs
    np.testing.assert_allclose(sv, np.asarray(res_j.s), rtol=1e-4)
    np.testing.assert_allclose(u, np.asarray(res_j.U), atol=1e-3)
    np.testing.assert_allclose(v, np.asarray(res_j.V), atol=1e-3)
    # against the SVD of the materialized delay embedding (test_08:368)
    s_ref = np.linalg.svd(delay_embed_np(x, d), compute_uv=False)
    np.testing.assert_allclose(sv, s_ref[:k], rtol=2e-3)
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=2e-3)


def test_hankel_wrapper_draws_from_generator(rng):
    """The public wrapper draws omega from the torch generator it is
    given: the same seed gives the same factors."""
    x = torch.from_numpy(_decaying(rng, 64, 32))
    a = hankel_randomized_svd_fused(
        x, 2, 4, generator=torch.Generator().manual_seed(5), gemm_dtype=torch.float32
    )
    b = hankel_randomized_svd_fused(
        x, 2, 4, generator=torch.Generator().manual_seed(5), gemm_dtype=torch.float32
    )
    for p, q in zip(a, b):
        assert torch.equal(p, q)
    s_ref = np.linalg.svd(delay_embed_np(x.numpy(), 2), compute_uv=False)
    np.testing.assert_allclose(a.s.numpy(), s_ref[:4], rtol=2e-3)


def test_stacked_sketch_matrix_parity(rng):
    from dmd_era5_tpu.ops.hankel import stacked_sketch_matrix as stacked_jax

    omega = rng.standard_normal((30, 5)).astype(np.float32)
    w_t = stacked_sketch_matrix(torch.from_numpy(omega), 3, 32).numpy()
    np.testing.assert_array_equal(w_t, np.asarray(stacked_jax(jnp.asarray(omega), 3, 32)))


@pytest.mark.parametrize("d", [1, 2, 4])
def test_hankel_exact_svd_matches_materialized_and_jax(rng, d):
    """test_08_kernels.py:444-468: against the f64 SVD of the materialized
    embedding (s rtol 1e-5, subspace > 1 - 1e-8, U^T U atol 1e-5), and
    against the JAX function (s to rtol 1e-5; U and V up to a sign per
    component, which neither side fixes, to the same 1e-5 scale)."""
    from dmd_era5_tpu.ops.hankel import hankel_exact_svd as hankel_exact_jax
    from dmd_era5_tpu_torch.ops.hankel import hankel_exact_svd

    s, t, k = 300, 64, 8
    a = rng.standard_normal((s, 16))
    b = rng.standard_normal((16, t))
    x = ((a * np.logspace(0, -2, 16)) @ b + 1e-4 * rng.standard_normal((s, t))).astype(
        np.float32
    )
    u0, s0, _ = np.linalg.svd(delay_embed_np(x, d).astype(np.float64), full_matrices=False)
    res = hankel_exact_svd(torch.from_numpy(x), d, k)
    u, sv, v = (r.numpy() for r in res)
    assert u.shape == (d * s, k) and v.shape == (k, t - d + 1)
    np.testing.assert_allclose(sv, s0[:k], rtol=1e-5)
    qa, _ = np.linalg.qr(u.astype(np.float64))
    qb, _ = np.linalg.qr(u0[:, :k])
    assert np.linalg.svd(qa.T @ qb, compute_uv=False).min() > 1 - 1e-8
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=1e-5)
    ref = hankel_exact_jax(jnp.asarray(x), d, k)
    np.testing.assert_allclose(sv, np.asarray(ref.s), rtol=1e-5)
    signs = np.sign(np.sum(u * np.asarray(ref.U), axis=0))
    np.testing.assert_allclose(u * signs, np.asarray(ref.U), atol=1e-5)
    np.testing.assert_allclose(v * signs[:, None], np.asarray(ref.V), atol=1e-5)


def test_hankel_randomized_svd_fused_d3_takes_two_passes(rng):
    """d = 3 at the standard k = 100: a 3 x 128 = 384-wide stacked sketch,
    past K1's N_MAX, so every pass takes the two-pass route (K2 + K3) in
    the port, where the JAX package runs its fused kernel; one omega
    drawn by JAX goes to both (test_08_kernels.py:346 covers d = 3)."""
    from dmd_era5_tpu_torch.ops import matmul

    s, t, d, k, n_over = 200, 160, 3, 100, 28
    x = _decaying(rng, s, t)
    t_out = t - d + 1
    assert matmul.takes_two_pass(t, d * (k + n_over), 4)
    omega = np.array(jax.random.normal(jax.random.key(0), (t_out, k + n_over), dtype=jnp.float32))
    res_j = hankel_jax(jnp.asarray(x), d, k, gemm_dtype=jnp.float32, seed=0)
    res_t = hankel_randomized_svd_fused_core(
        torch.from_numpy(x), d, k, torch.from_numpy(omega), gemm_dtype=torch.float32
    )
    u, sv, v = (r.numpy() for r in res_t)
    assert u.shape == (d * s, k) and v.shape == (k, t_out)
    assert matmul.sketch_center_gram_project.launches == 0
    s_j = np.asarray(res_j.s)
    # test_08:147-153's rtol; past the signal the values sit at the noise
    # floor, which f32 resolves only to ~1e-6 of s[0]
    np.testing.assert_allclose(sv, s_j, rtol=1e-4, atol=1e-5 * s_j[0])
    # the decaying signal's components (test_08_kernels.py:147-153 on U and
    # V); past them the values sit at the noise floor, where U and V are
    # any basis of a nearly degenerate subspace
    lead = int(np.sum(s_j > 1e-2 * s_j[0]))
    np.testing.assert_allclose(u[:, :lead], np.asarray(res_j.U)[:, :lead], atol=1e-3)
    np.testing.assert_allclose(v[:lead], np.asarray(res_j.V)[:lead], atol=1e-3)
    s_ref = np.linalg.svd(delay_embed_np(x, d), compute_uv=False)
    np.testing.assert_allclose(sv[:lead], s_ref[:lead], rtol=2e-3)
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=2e-3)
