"""Parity of the port's small-matrix linear algebra with the JAX package.

Same numpy inputs through ``dmd_era5_tpu.utils.linalg`` and
``dmd_era5_tpu_torch.utils.linalg``, at the tolerances of
tests/test_25_linalg.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.utils import linalg as jl
from dmd_era5_tpu_torch.utils import linalg as tl


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _spd(rng, n, cond=1e4):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.logspace(0, -np.log10(cond), n)
    return (q * d) @ q.T


@pytest.mark.parametrize("batched", [False, True])
def test_spd_solve_parity(rng, batched):
    shape = (4,) if batched else ()
    a = np.stack([_spd(rng, 24) for _ in range(4)]) if batched else _spd(rng, 24)
    a = a.astype(np.float32)
    b = rng.standard_normal(shape + (24, 5)).astype(np.float32)
    x_t = tl.spd_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    x_j = np.asarray(jl.spd_solve(jnp.asarray(a), jnp.asarray(b)))
    x_ref = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    tol = 1e-3 * np.abs(x_ref).max()
    assert np.allclose(x_t, x_ref, rtol=0, atol=tol)
    assert np.allclose(x_t, x_j, rtol=0, atol=tol)


@pytest.mark.parametrize("cond", [1e2, 1e9])
def test_safe_cholesky_and_gram_whiten_parity(rng, cond):
    """Both the plain factor and the ridge escalation (cond 1e9 is past
    f32 Cholesky's reach without the ridge) agree with the JAX factors."""
    g = _spd(rng, 32, cond=cond).astype(np.float32)
    l_t = tl.safe_cholesky(torch.from_numpy(g)).numpy()
    l_j = np.asarray(jl.safe_cholesky(jnp.asarray(g)))
    assert np.all(np.isfinite(l_t))
    # both factor G plus the same trace-relative ridge
    assert np.allclose(l_t @ l_t.T, l_j @ l_j.T, rtol=0, atol=1e-5 * np.abs(g).max())
    if cond < 1e6:  # past 1/eps_f32 the trailing pivots are roundoff
        assert np.allclose(l_t, l_j, rtol=0, atol=1e-4 * np.abs(l_j).max())
    w_t = tl.gram_whiten(torch.from_numpy(g)).numpy()
    w_j = np.asarray(jl.gram_whiten(jnp.asarray(g)))
    # the whitened Gram W G W^T is the identity on the resolved directions
    m_t = w_t @ g.astype(np.float64) @ w_t.T
    m_j = w_j @ g.astype(np.float64) @ w_j.T
    if cond < 1e6:
        assert np.allclose(m_t, np.eye(32), atol=5e-5)
        assert np.allclose(m_t, m_j, atol=5e-5)
    else:
        # G's eigenvalues under eps_f32 * ||G|| are not carried by the
        # f32 Gram, so the ridge-shrunk directions differ by roundoff of
        # that order between the two factorizations (measured 1.5e-2)
        e_t, e_j = np.linalg.eigvalsh(m_t), np.linalg.eigvalsh(m_j)
        assert np.allclose(e_t, e_j, atol=3e-2)
        assert np.sum(np.abs(e_t - 1.0) < 1e-3) >= 12  # d_i > ~1e-5


def test_orth_small_parity(rng):
    z = rng.standard_normal((200, 16)).astype(np.float32)
    z[:, :4] *= 50.0
    q = tl.orth_small(torch.from_numpy(z)).numpy()
    q_j = np.asarray(jl.orth_small(jnp.asarray(z)))
    assert np.allclose(q.T @ q, np.eye(16), atol=5e-5)
    assert np.allclose(q @ (q.T @ z), z, atol=1e-3 * np.abs(z).max())
    # same whitener algebra: the bases agree column by column
    assert np.allclose(q, q_j, atol=1e-3)


def test_eig_sorted_matches_eig_host(rng):
    a = rng.standard_normal((8, 8)).astype(np.float32)
    w_t, v_t = tl.eig_sorted(torch.from_numpy(a))
    w_j, v_j = jl.eig_host(jnp.asarray(a))
    w_t, v_t, w_j, v_j = (np.asarray(o) for o in (w_t, v_t, w_j, v_j))
    np.testing.assert_allclose(np.abs(w_t), np.sort(np.abs(w_t))[::-1])
    np.testing.assert_allclose(np.abs(w_t), np.abs(w_j), rtol=1e-5)
    # a conjugate pair ties in |lambda|, so its order within the tie is
    # roundoff: match each eigenvalue to its nearest counterpart, and
    # its eigenvector up to a unit complex phase
    for i in range(8):
        j = int(np.argmin(np.abs(w_j - w_t[i])))
        assert abs(w_j[j] - w_t[i]) < 1e-4
        phase = np.vdot(v_t[:, i], v_j[:, j])
        assert abs(abs(phase) - 1.0) < 1e-4
        np.testing.assert_allclose(v_t[:, i] * phase, v_j[:, j], atol=1e-4)
    assert np.allclose(a @ v_t, v_t * w_t[None, :], atol=1e-4)


@pytest.mark.parametrize("hpd", [False, True])
def test_complex_solve_parity(rng, hpd):
    n = 10
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = (m @ m.conj().T + n * np.eye(n)).astype(np.complex64)
    b = (rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))).astype(
        np.complex64
    )
    x_t = tl.complex_solve(torch.from_numpy(a), torch.from_numpy(b), hpd=hpd).numpy()
    x_j = np.asarray(jl.complex_solve(jnp.asarray(a), jnp.asarray(b), hpd=hpd))
    x_ref = np.linalg.solve(a.astype(np.complex128), b.astype(np.complex128))
    scale = np.abs(x_ref).max()
    assert np.allclose(x_t, x_ref, atol=1e-4 * scale)
    assert np.allclose(x_t, x_j, atol=1e-4 * scale)


@pytest.mark.parametrize("ridge", [0.0, 1e-7])
def test_complex_lstsq_parity(rng, ridge):
    a = (rng.standard_normal((40, 6)) + 1j * rng.standard_normal((40, 6))).astype(
        np.complex64
    )
    x_true = (rng.standard_normal(6) + 1j * rng.standard_normal(6)).astype(
        np.complex64
    )
    b = a @ x_true
    x_t = tl.complex_lstsq(torch.from_numpy(a), torch.from_numpy(b), ridge).numpy()
    x_j = np.asarray(jl.complex_lstsq(jnp.asarray(a), jnp.asarray(b), ridge))
    assert np.allclose(x_t, x_true, atol=1e-3)
    assert np.allclose(x_t, x_j, atol=1e-3)
