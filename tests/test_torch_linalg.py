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


# ---- lstsq_implicit: the implicit-differentiation rule ----------------
#
# tests/test_13_checkpoint.py:78-115's case, theta (2r,) -> B = lstsq(Phi,
# H) with Phi = exp(t alpha^T), B flattened to its real and imaginary
# parts, through both packages' lstsq_implicit.

LSTSQ_CASES = [pytest.param(0.0, False, id="test13"), pytest.param(0.5, False, id="ridge"),
               pytest.param(0.0, True, id="1d-b")]


def _theta_case(one_column: bool):
    rng = np.random.default_rng(0)  # test_13's fixture
    t, k = 20, 4
    tt = np.arange(t, dtype=np.float32) * 0.1
    h = (rng.standard_normal((t, k)) + 1j * rng.standard_normal((t, k))).astype(np.complex64)
    if one_column:
        h = h[:, 0].copy()
    alpha = np.array([-0.1 + 1.0j, -0.2 - 0.5j, -0.05 + 2.0j], dtype=np.complex64)
    theta = np.concatenate([alpha.real, alpha.imag]).astype(np.float32)
    return tt, h, theta


def _n_out(h) -> int:
    """Entries of theta -> B's output: B is (r, k) or (r,), real and
    imaginary parts."""
    return 2 * 3 * (h.shape[1] if h.ndim == 2 else 1)


def _b_of_theta_jax(tt, h, ridge):
    r = 3

    def f(theta):
        a = theta[:r] + 1j * theta[r:]
        b = jl.lstsq_implicit(jnp.exp(jnp.outer(jnp.asarray(tt), a)), jnp.asarray(h), ridge)
        return jnp.concatenate([jnp.real(b).ravel(), jnp.imag(b).ravel()])
    return f


def _b_of_theta_torch(tt, h, ridge, solve=None):
    r = 3
    solve = solve or (lambda phi, hh: tl.lstsq_implicit(phi, hh, ridge))
    tt_t, h_t = torch.from_numpy(tt), torch.from_numpy(h)

    def f(theta):
        a = torch.complex(theta[:r], theta[r:])
        b = solve(torch.exp(torch.outer(tt_t.to(a.dtype), a)), h_t)
        return torch.cat([b.real.reshape(-1), b.imag.reshape(-1)])
    return f


@pytest.mark.parametrize("ridge,one_column", LSTSQ_CASES)
def test_lstsq_implicit_primal_parity(ridge, one_column):
    tt, h, theta = _theta_case(one_column)
    got = _b_of_theta_torch(tt, h, ridge)(torch.from_numpy(theta)).numpy()
    want = np.asarray(_b_of_theta_jax(tt, h, ridge)(jnp.asarray(theta)))
    direct = _b_of_theta_torch(tt, h, ridge, lambda p, hh: tl.complex_lstsq(p, hh, ridge))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(got, direct(torch.from_numpy(theta)).numpy())


@pytest.mark.parametrize("ridge,one_column", LSTSQ_CASES)
def test_lstsq_implicit_jacfwd_matches_jax(ridge, one_column):
    """``torch.func.jacfwd`` through the rule (vmapped) against JAX's
    jacfwd through its custom_jvp, at test_13's rtol 1e-3, atol 1e-4;
    and against forward mode straight through the port's solve."""
    import jax

    from dmd_era5_tpu_torch.models.optdmd import _func

    tt, h, theta = _theta_case(one_column)
    j_t = _func().jacfwd(_b_of_theta_torch(tt, h, ridge))(torch.from_numpy(theta)).numpy()
    j_j = np.asarray(jax.jacfwd(_b_of_theta_jax(tt, h, ridge))(jnp.asarray(theta)))
    direct = _b_of_theta_torch(tt, h, ridge, lambda p, hh: tl.complex_lstsq(p, hh, ridge))
    j_d = _func().jacfwd(direct)(torch.from_numpy(theta)).numpy()
    assert j_t.shape == j_j.shape == (_n_out(h), 6)
    np.testing.assert_allclose(j_t, j_j, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(j_t, j_d, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("ridge,one_column", LSTSQ_CASES)
def test_lstsq_implicit_reverse_mode_is_the_transposed_jacobian(ridge, one_column):
    """``torch.autograd.grad`` of c . B(theta) through the rule's backward
    equals c^T J with J JAX's forward Jacobian (reverse mode as JAX's
    transposed JVP)."""
    import jax

    tt, h, theta = _theta_case(one_column)
    c = np.random.default_rng(1).standard_normal(_n_out(h)).astype(np.float32)
    th = torch.from_numpy(theta).requires_grad_(True)
    out = _b_of_theta_torch(tt, h, ridge)(th)
    (grad,) = torch.autograd.grad(out, th, torch.from_numpy(c))
    j_j = np.asarray(jax.jacfwd(_b_of_theta_jax(tt, h, ridge))(jnp.asarray(theta)))
    np.testing.assert_allclose(grad.numpy(), c @ j_j, rtol=1e-3, atol=1e-4 * np.abs(c @ j_j).max())
