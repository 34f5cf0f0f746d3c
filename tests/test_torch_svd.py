"""Parity of the port's truncated SVD routes with the JAX package.

The same numpy inputs go through ``dmd_era5_tpu.ops.svd`` (its Pallas
kernels in interpret mode on the CPU) and ``dmd_era5_tpu_torch.ops.svd``
(the kernels' plain PyTorch versions on CPU tensors).  The exact routes
are deterministic and flip no signs, so singular vectors are compared up
to a sign per component; the randomized core takes one shared sketch,
so every iterate is shared.  Tolerances are the JAX tests', cited.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_03_svd import lowrank_matrix, subspace_angle_err

from dmd_era5_tpu.ops import svd as jsvd
from dmd_era5_tpu_torch.ops import svd as tsvd


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _assert_matches_up_to_sign(u, v, u_ref, v_ref, atol):
    for j in range(u.shape[1]):
        sign = np.sign(np.dot(u[:, j], u_ref[:, j]))
        np.testing.assert_allclose(u[:, j] * sign, u_ref[:, j], atol=atol)
        np.testing.assert_allclose(v[j] * sign, v_ref[j], atol=atol)


@pytest.mark.parametrize("route", ["gram_highest", "gram_bf16_split", "tsqr"])
def test_exact_routes_match_numpy_and_jax(rng, route):
    """test_03_svd.py:149-190: s rtol 2e-3, vectors atol 5e-3, U^T U
    atol 1e-4; against the JAX route of the same name to the same."""
    x = lowrank_matrix(rng, 1024, 32, rank=12)
    k = 8
    if route == "tsqr":
        res = tsvd.exact_truncated_svd(_t(x), k)
        ref = jsvd.exact_truncated_svd(jnp.asarray(x), k)
    else:
        precision = route.removeprefix("gram_")
        res = tsvd.exact_truncated_svd_gram(_t(x), k, gram_precision=precision)
        ref = jsvd.exact_truncated_svd_gram(
            jnp.asarray(x), k,
            gram_precision=jsvd.HIGHEST if precision == "highest" else precision,
        )
    u, s, v = (o.numpy() for o in res)
    assert u.shape == (1024, k) and s.shape == (k,) and v.shape == (k, 32)
    u_np, s_np, vt_np = np.linalg.svd(x, full_matrices=False)
    np.testing.assert_allclose(s, s_np[:k], rtol=2e-3)
    _assert_matches_up_to_sign(u, v, u_np, vt_np, atol=5e-3)
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=1e-4)
    np.testing.assert_allclose(s, np.asarray(ref.s), rtol=2e-3)
    _assert_matches_up_to_sign(u, v, np.asarray(ref.U), np.asarray(ref.V), atol=5e-3)


def test_gram_route_split_precision_restores_f32(rng):
    """test_25_linalg.py:106-117: the split Gram's subspace, through
    Rayleigh-Ritz, gives s to rtol 1e-5 and the subspace to 1 - 1e-6."""
    x = rng.standard_normal((512, 48)).astype(np.float32)
    u0, s0, _ = np.linalg.svd(x, full_matrices=False)
    res = tsvd.exact_truncated_svd_gram(_t(x), 8, gram_precision="bf16_split")
    np.testing.assert_allclose(res.s.numpy(), s0[:8], rtol=1e-5)
    ov = u0[:, :8].T @ res.U.numpy().astype(np.float64)
    assert np.linalg.svd(ov)[1].min() > 1 - 1e-6
    ref = jsvd.exact_truncated_svd_gram(jnp.asarray(x), 8, gram_precision="bf16_split")
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-5)


@pytest.mark.parametrize("qr_method", ["householder", "cholqr2_split"])
@pytest.mark.parametrize("n_iter", [0, 4])
def test_rand_svd_core_parity(rng, qr_method, n_iter):
    """One shared omega through both cores: s rtol 1e-3, U atol 5e-3
    (test_03_svd.py:265-275), V to the same."""
    x = lowrank_matrix(rng, 1024, 32, rank=8, noise=1e-4)
    k, r = 6, 16
    omega = rng.standard_normal((32, r)).astype(np.float32)
    u, s, v = (o.numpy() for o in tsvd._rand_svd_core(
        _t(x), _t(omega), k, n_iter, torch.float32, qr_method
    ))
    u_j, s_j, v_j = (np.asarray(o) for o in jsvd._rand_svd_core(
        jnp.asarray(x), jnp.asarray(omega), k, n_iter, None, jnp.float32, qr_method
    ))
    assert u.shape == (1024, k) and v.shape == (k, 32)
    np.testing.assert_allclose(s, s_j, rtol=1e-3)
    np.testing.assert_allclose(u, u_j, atol=5e-3)
    np.testing.assert_allclose(v, v_j, atol=5e-3)


def test_rand_svd_core_bf16_gemms(rng):
    """bf16 inputs to the S-sized products, f32 sums, on both sides:
    test_03_svd.py:279-285's tolerances against numpy (s rtol 2e-2,
    subspace 5e-2), and the JAX core's s to the same."""
    x = lowrank_matrix(rng, 1024, 32, rank=8, noise=1e-4)
    omega = rng.standard_normal((32, 16)).astype(np.float32)
    u, s, _ = (o.numpy() for o in tsvd._rand_svd_core(
        _t(x), _t(omega), 6, 4, torch.bfloat16, "householder"
    ))
    _, s_j, _ = jsvd._rand_svd_core(
        jnp.asarray(x), jnp.asarray(omega), 6, 4, None, jnp.bfloat16, "householder"
    )
    u_np, s_np, _ = np.linalg.svd(x, full_matrices=False)
    np.testing.assert_allclose(s, s_np[:6], rtol=2e-2)
    assert subspace_angle_err(u, u_np[:, :6]) < 5e-2
    np.testing.assert_allclose(s, np.asarray(s_j), rtol=2e-2)


def test_randomized_svd_subspace_and_seed(rng):
    """test_03_svd.py:231-243 (s rtol 1e-2, subspaces 1e-3); the same
    seed, as an int or a generator, gives the same factors."""
    x = lowrank_matrix(rng, 1024, 64, rank=10, noise=1e-4)
    res = tsvd.randomized_svd(_t(x), 10, seed=0)
    u_np, s_np, vt_np = np.linalg.svd(x, full_matrices=False)
    np.testing.assert_allclose(res.s.numpy(), s_np[:10], rtol=1e-2)
    assert subspace_angle_err(res.U.numpy(), u_np[:, :10]) < 1e-3
    assert subspace_angle_err(res.V.numpy().T, vt_np[:10].T) < 1e-3
    again = tsvd.randomized_svd(_t(x), 10, seed=torch.Generator().manual_seed(0))
    for a, b in zip(res, again):
        assert torch.equal(a, b)


def test_truncated_svd_standard_auto_routes_gram_when_tall(monkeypatch):
    """test_03_svd.py:193-217: decisively tall-skinny -> gram, else TSQR."""
    rng = np.random.default_rng(3)
    x_tall = lowrank_matrix(rng, 512, 16, rank=4)
    x_square = lowrank_matrix(rng, 64, 32, rank=4)
    calls = []
    for name in ("exact_truncated_svd_gram", "exact_truncated_svd"):
        orig = getattr(tsvd, name)
        monkeypatch.setattr(
            tsvd, name, lambda *a, _o=orig, _n=name, **kw: (calls.append(_n), _o(*a, **kw))[1]
        )
    tsvd.truncated_svd(_t(x_tall), 4, svd_type="standard")
    tsvd.truncated_svd(_t(x_square), 4, svd_type="standard")
    tsvd.truncated_svd(_t(x_tall), 4, svd_type="standard", exact_method="tsqr")
    assert calls == ["exact_truncated_svd_gram", "exact_truncated_svd", "exact_truncated_svd"]


def test_truncated_svd_dispatch(rng):
    """test_03_svd.py:291-299, and the exact default's route parity."""
    x = lowrank_matrix(rng, 256, 16, rank=4)
    for svd_type in ("standard", "randomized"):
        res = tsvd.truncated_svd(_t(x), 4, svd_type=svd_type)
        assert res.U.shape == (256, 4)
        assert res.s.shape == (4,)
        assert res.V.shape == (4, 16)
    with pytest.raises(ValueError, match="not supported"):
        tsvd.truncated_svd(_t(x), 4, svd_type="magic")
    res = tsvd.truncated_svd(_t(x), 4)
    ref = jsvd.truncated_svd(jnp.asarray(x), 4)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=2e-3)


@pytest.mark.parametrize("precision", ["highest", "bf16_split"])
def test_raw_gram_above_kernel_range(rng, precision):
    """T above the JAX Gram kernel's range (1024), where the JAX raw_gram
    takes XLA's product (svd.py:138-147): the port's Gram, which has no
    such range, against it; test_25_linalg.py:102's tolerances."""
    x = rng.standard_normal((64, 1024 + 6)).astype(np.float32)
    g = tsvd.raw_gram(_t(x), precision).numpy()
    g_j = np.asarray(jsvd.raw_gram(
        jnp.asarray(x), jsvd.HIGHEST if precision == "highest" else precision, True
    ))
    g_ref = x.astype(np.float64).T @ x.astype(np.float64)
    tol = (1e-5 if precision == "highest" else 3e-5) * np.abs(g_ref).max()
    assert np.allclose(g, g_ref, rtol=0, atol=tol)
    assert np.allclose(g, g_j, rtol=0, atol=tol)
