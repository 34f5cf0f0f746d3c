"""Parity of the port's DMDc with the JAX package's.

The known forced linear systems of tests/test_27_dmdc.py go, as the same
numpy arrays, through ``dmd_era5_tpu.models.dmdc`` and the port's
counterpart on the CPU, at test_27's tolerances: the unforced spectrum
to 2e-3 (both packages, and one against the other, eigenvalues matched
nearest first), the reduced input map to 5e-3, the rollouts to 1e-3
(1e-2 on unseen inputs).  The reduced operators are compared through
their own bases (u_hat B_red and u_hat A_red u_hat^T), since the output
POD basis is fixed only up to a rotation within its span.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_05_dmd import matched_eig_error
from test_27_dmdc import _forced_system
from test_torch_optdmd import _match

from dmd_era5_tpu.models import dmdc as dmdc_jax
from dmd_era5_tpu.models.dmd import exact_dmd as exact_dmd_jax
from dmd_era5_tpu_torch.models import dmdc, exact_dmd


def _fit_both(x, u_seq, **kw):
    return dmdc.fit_dmdc(x, u_seq, device="cpu", **kw), dmdc_jax.fit_dmdc(x, u_seq, **kw)


def _lifted(res):
    """(u_hat B_red, u_hat A_red u_hat^T): the reduced maps in full space."""
    u_hat = np.asarray(res.u_hat, dtype=np.float64)
    return u_hat @ np.asarray(res.b_red), u_hat @ np.asarray(res.a_red) @ u_hat.T


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def test_spectrum_and_trajectory_recovery():
    x, u_seq, a0, _, _ = _forced_system()
    res, res_j = _fit_both(x, u_seq, rank=4)
    lam_ref = np.linalg.eigvals(a0)
    got = res.eigenvalues.numpy()
    assert matched_eig_error(got, lam_ref) < 2e-3
    idx = _match(got, np.asarray(res_j.eigenvalues))
    np.testing.assert_allclose(got[idx], res_j.eigenvalues, rtol=0, atol=2e-3)
    xr = dmdc.dmdc_rollout(res, x[:, 0], u_seq).numpy()
    assert _rel(xr, x) < 1e-3
    xr_j = np.asarray(dmdc_jax.dmdc_rollout(res_j, x[:, 0], u_seq))
    assert _rel(xr, xr_j) < 1e-3
    assert res.residual < 1e-3 and abs(res.residual - res_j.residual) < 1e-3


def test_reduced_input_map():
    x, u_seq, _, b0, u_true = _forced_system()
    res, res_j = _fit_both(x, u_seq, rank=4)
    u_hat = res.u_hat.numpy()
    np.testing.assert_allclose(res.b_red.numpy(), (u_hat.T @ u_true) @ b0, rtol=0, atol=5e-3)
    for mine, theirs in zip(_lifted(res), _lifted(res_j)):
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=5e-3)


def test_generalizes_to_unseen_inputs():
    x, u_seq, a0, b0, u_true = _forced_system()
    res, res_j = _fit_both(x, u_seq, rank=4)
    rng = np.random.default_rng(7)
    u_new = rng.standard_normal((2, 40)).astype(np.float32)
    z = u_true.T @ x[:, -1]
    x_true = [x[:, -1]]
    for k in range(u_new.shape[1]):
        z = a0 @ z + b0 @ u_new[:, k]
        x_true.append(u_true @ z)
    x_true = np.stack(x_true, axis=1).astype(np.float32)
    xr = dmdc.dmdc_rollout(res, x[:, -1], u_new).numpy()
    assert _rel(xr, x_true) < 1e-2
    assert _rel(xr, np.asarray(dmdc_jax.dmdc_rollout(res_j, x[:, -1], u_new))) < 1e-2


def test_beats_uncontrolled_dmd_on_forced_data():
    x, u_seq, a0, _, _ = _forced_system(seed=3)
    lam_ref = np.linalg.eigvals(a0)
    res, res_j = _fit_both(x, u_seq, rank=4)
    err_c = matched_eig_error(res.eigenvalues.numpy(), lam_ref)
    err_plain = matched_eig_error(exact_dmd(torch.from_numpy(x), rank=4).eigenvalues.numpy(),
                                  lam_ref)
    assert err_c < 0.1 * err_plain, (err_c, err_plain)
    err_c_j = matched_eig_error(np.asarray(res_j.eigenvalues), lam_ref)
    err_plain_j = matched_eig_error(np.asarray(exact_dmd_jax(x, rank=4).eigenvalues), lam_ref)
    assert err_c_j < 0.1 * err_plain_j
    assert abs(err_plain - err_plain_j) < 1e-3 * max(err_plain_j, 1.0)


def test_control_recovery_under_magnitude_imbalance():
    """States 1e3x, controls 1e-3x: the control map survives the row
    balancing and comes back in the raw input units."""
    x, u_seq, _, b0, u_true = _forced_system()
    scale_x, scale_u = 1e3, 1e-3
    x_big = (x * scale_x).astype(np.float32)
    u_small = (u_seq * scale_u).astype(np.float32)
    res, res_j = _fit_both(x_big, u_small, rank=4)
    u_hat = res.u_hat.numpy()
    b_red_ref = (u_hat.T @ u_true) @ b0 * (scale_x / scale_u)
    np.testing.assert_allclose(res.b_red.numpy(), b_red_ref, rtol=2e-3,
                               atol=2e-3 * abs(b_red_ref).max())
    lifted, lifted_j = _lifted(res)[0], _lifted(res_j)[0]
    np.testing.assert_allclose(lifted, lifted_j, rtol=2e-3, atol=2e-3 * abs(lifted_j).max())
    xr = dmdc.dmdc_rollout(res, x_big[:, 0], u_small).numpy()
    assert _rel(xr, x_big) < 1e-3
    res0 = dmdc.fit_dmdc(x_big, np.zeros_like(u_small), rank=4, device="cpu")
    assert torch.isfinite(res0.b_red).all()


def test_input_shape_validation():
    x, u_seq, *_ = _forced_system()
    with pytest.raises(ValueError, match=r"\(q, T-1\)"):
        dmdc.fit_dmdc(x, u_seq[:, :-3], rank=4, device="cpu")


def test_dmdc_from_svd_matches_full_route():
    """The stage's route (dmdc_from_svd on U, s, V) recovers the same
    spectrum and trajectory as the full route, its modes and lift basis
    in full space, in both packages."""
    x, u_seq, a0, _, _ = _forced_system()
    uu, ss, vvt = np.linalg.svd(x, full_matrices=False)
    k = 6
    factors = [np.ascontiguousarray(a) for a in (uu[:, :k], ss[:k], vvt[:k])]
    res = dmdc.dmdc_from_svd(*(torch.from_numpy(a) for a in factors), u_seq, rank=4)
    res_j = dmdc_jax.dmdc_from_svd(*(jnp.asarray(a) for a in factors), jnp.asarray(u_seq), rank=4)
    got = res.eigenvalues.numpy()
    assert matched_eig_error(got, np.linalg.eigvals(a0)) < 2e-3
    idx = _match(got, np.asarray(res_j.eigenvalues))
    np.testing.assert_allclose(got[idx], res_j.eigenvalues, rtol=0, atol=2e-3)
    assert res.residual < 1e-3
    assert res.modes.shape == res.u_hat.shape == (x.shape[0], 4)
    np.testing.assert_allclose(torch.linalg.vector_norm(res.modes, dim=0).numpy(), 1.0,
                               rtol=1e-5)
    # the same modes up to each column's phase
    overlap = np.abs(np.sum(np.conj(np.asarray(res_j.modes)) * res.modes.numpy()[:, idx], axis=0))
    np.testing.assert_allclose(overlap, 1.0, atol=1e-3)
    xr = dmdc.dmdc_rollout(res, x[:, 0], u_seq).numpy()
    assert _rel(xr, x) < 1e-3


def test_dmdc_rank_omega_validation():
    x, u_seq, *_ = _forced_system()
    with pytest.raises(ValueError, match="rank_omega"):
        dmdc.fit_dmdc(x, u_seq, rank=4, rank_omega=0, device="cpu")
