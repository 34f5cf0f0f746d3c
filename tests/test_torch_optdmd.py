"""Parity of the port's DMD models and forecast with the JAX package.

The linear systems of tests/test_05_dmd.py (known continuous-time
eigenvalues) go through the truncated SVD once, in numpy, and the same
factors feed ``dmd_era5_tpu.models`` and ``dmd_era5_tpu_torch.models``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_05_dmd import make_linear_system, matched_eig_error

from dmd_era5_tpu import models as jm
from dmd_era5_tpu_torch import convert
from dmd_era5_tpu_torch import models as tm
from dmd_era5_tpu_torch.snapmat import standardize_data


def _svd(x, k):
    u, s, vt = np.linalg.svd(x.astype(np.float64), full_matrices=False)
    return (a.astype(np.float32) for a in (u[:, :k], s[:k], vt[:k]))


def _match(found, ref):
    """Index into ``found`` of the nearest entry for each of ``ref``."""
    left = list(range(len(found)))
    out = []
    for r in ref:
        i = min(left, key=lambda j: abs(found[j] - r))
        out.append(i)
        left.remove(i)
    return np.asarray(out)


@pytest.mark.parametrize("n_hist", [64, 48])
def test_optdmd_from_svd_parity(rng, n_hist):
    x, t, alpha_true = make_linear_system(rng)
    u, s, vt = _svd(x[:, :n_hist], 4)
    res_j = jm.optdmd_from_svd(
        jnp.asarray(u), jnp.asarray(s), jnp.asarray(vt), jnp.asarray(t[:n_hist]), rank=4
    )
    res_t = tm.optdmd_from_svd(
        torch.from_numpy(u), torch.from_numpy(s), torch.from_numpy(vt),
        torch.from_numpy(t[:n_hist]), rank=4,
    )
    a_t, a_j = res_t.alpha.numpy(), np.asarray(res_j.alpha)
    # both recover the truth (test_05_dmd.py:84) and fit to 1e-3
    assert matched_eig_error(a_t, alpha_true) < 5e-3
    assert matched_eig_error(a_j, alpha_true) < 5e-3
    assert float(res_t.residual) < 1e-3 and float(res_j.residual) < 1e-3
    # the two sides agree after matching eigenvalues
    idx = _match(a_t, a_j)
    np.testing.assert_allclose(a_t[idx], a_j, atol=1e-3)
    np.testing.assert_allclose(
        res_t.amplitudes.numpy()[idx], np.asarray(res_j.amplitudes), rtol=1e-3
    )
    np.testing.assert_allclose(
        np.linalg.norm(res_t.modes.numpy(), axis=0), 1.0, atol=1e-3
    )
    # the forecast past the fitted window extrapolates the system
    full = tm.rollout(res_t, torch.from_numpy(t)).numpy()
    rel = np.linalg.norm(full - x) / np.linalg.norm(x)
    assert rel < 0.05


def test_rollout_parity_on_one_model(rng):
    """The JAX fit, carried across by ``convert``, rolls out the same."""
    x, t, _ = make_linear_system(rng)
    u, s, vt = _svd(x, 4)
    res_j = jm.optdmd_from_svd(
        jnp.asarray(u), jnp.asarray(s), jnp.asarray(vt), jnp.asarray(t), rank=4
    )
    res_t = convert.optdmd_result_from_numpy(*res_j, device="cpu")
    t_f = np.asarray(jm.forecast_times(len(t), 24, float(t[1] - t[0])))
    t_t = tm.forecast_times(len(t), 24, float(t[1] - t[0]), device="cpu")
    np.testing.assert_allclose(t_t.numpy(), t_f, rtol=1e-6)
    out_t = tm.rollout(res_t, t_t).numpy()
    out_j = np.asarray(jm.rollout(res_j, jnp.asarray(t_f)))
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5 * np.abs(out_j).max())


def test_dmd_from_svd_parity(rng):
    x, t, alpha_true = make_linear_system(rng)
    dt = float(t[1] - t[0])
    u, s, vt = _svd(x[:, :-1], 4)
    x2 = x[:, 1:]
    res_j = jm.dmd_from_svd(jnp.asarray(x2), jnp.asarray(u), jnp.asarray(s), jnp.asarray(vt), dt)
    res_t = tm.dmd_from_svd(
        torch.from_numpy(x2), torch.from_numpy(u), torch.from_numpy(s),
        torch.from_numpy(vt), dt,
    )
    w_t, w_j = res_t.omega.numpy(), np.asarray(res_j.omega)
    assert matched_eig_error(w_t, alpha_true) < 1e-2  # test_05_dmd.py:66
    idx = _match(w_t, w_j)
    np.testing.assert_allclose(w_t[idx], w_j, atol=1e-3)
    np.testing.assert_allclose(
        res_t.eigenvalues.numpy()[idx], np.asarray(res_j.eigenvalues), atol=1e-4
    )
    # modes and amplitudes carry a free phase per mode; their product
    # does not, so compare the reconstructions
    rec_t = tm.rollout(res_t, torch.from_numpy(t)).numpy()
    rec_j = np.asarray(jm.rollout(res_j, jnp.asarray(t)))
    np.testing.assert_allclose(rec_t, rec_j, atol=1e-3 * np.abs(rec_j).max())
    assert np.linalg.norm(rec_t - x) / np.linalg.norm(x) < 1e-2  # test_05:74


def test_standardize_and_undo_preprocessing_parity(rng):
    s, d, nt = 10, 3, 7
    raw = rng.standard_normal((s, nt + d - 1)).astype(np.float32) * 3 + 1
    std_t, mean_t, sd_t = standardize_data(torch.from_numpy(raw))
    np.testing.assert_allclose(mean_t.numpy(), raw.mean(axis=1), rtol=1e-6)
    np.testing.assert_allclose(sd_t.numpy(), raw.std(axis=1), rtol=1e-5)
    centered, _, none = standardize_data(torch.from_numpy(raw), scale=False)
    assert none is None
    np.testing.assert_allclose(centered.numpy(), raw - raw.mean(axis=1, keepdims=True), atol=1e-5)

    from dmd_era5_tpu.snapmat import delay_embed_np

    emb = delay_embed_np(std_t.numpy(), d)
    mean_d, sd_d = np.tile(mean_t.numpy(), d), np.tile(sd_t.numpy(), d)
    out_t = tm.undo_preprocessing(
        torch.from_numpy(emb), torch.from_numpy(mean_d), torch.from_numpy(sd_d), delay=d
    ).numpy()
    out_j = np.asarray(jm.undo_preprocessing(
        jnp.asarray(emb), jnp.asarray(mean_d), jnp.asarray(sd_d), delay=d
    ))
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)
    np.testing.assert_allclose(out_t, raw[:, d - 1 :], atol=1e-5)  # test_05:236


# ------------------------------------- the rest of tests/test_05_dmd.py


def test_exact_dmd_and_reconstruct_parity(rng):
    """exact_dmd recovers the system (test_05_dmd.py:62-76) in both
    packages, and the two reconstructions agree."""
    x, t, alpha_true = make_linear_system(rng)
    dt = float(t[1] - t[0])
    res_t = tm.exact_dmd(torch.from_numpy(x), rank=4, dt=dt)
    res_j = jm.exact_dmd(jnp.asarray(x), rank=4, dt=dt)
    w_t = res_t.omega.numpy()
    assert matched_eig_error(w_t, alpha_true) < 1e-2
    idx = _match(w_t, np.asarray(res_j.omega))
    np.testing.assert_allclose(w_t[idx], np.asarray(res_j.omega), atol=1e-3)
    rec_t = tm.reconstruct(res_t, x.shape[1]).numpy()
    rec_j = np.asarray(jm.reconstruct(res_j, x.shape[1]))
    assert np.linalg.norm(rec_t - x) / np.linalg.norm(x) < 1e-2
    np.testing.assert_allclose(rec_t, rec_j, atol=1e-3 * np.abs(rec_j).max())


def test_fit_optdmd_and_reconstruct_parity(rng):
    """fit_optdmd on the first 48 steps extrapolates the next 16
    (test_05_dmd.py:80-86, :206-216), as the JAX fit does."""
    x, t, alpha_true = make_linear_system(rng, n_t=64)
    res_t = tm.fit_optdmd(torch.from_numpy(x[:, :48]), torch.from_numpy(t[:48]), rank=4)
    res_j = jm.fit_optdmd(jnp.asarray(x[:, :48]), jnp.asarray(t[:48]), rank=4)
    a_t = res_t.alpha.numpy()
    assert matched_eig_error(a_t, alpha_true) < 5e-3
    assert float(res_t.residual) < 1e-3
    idx = _match(a_t, np.asarray(res_j.alpha))
    np.testing.assert_allclose(a_t[idx], np.asarray(res_j.alpha), atol=1e-3)
    full_t = tm.optdmd_reconstruct(res_t, torch.from_numpy(t)).numpy()
    full_j = np.asarray(jm.optdmd_reconstruct(res_j, jnp.asarray(t)))
    rel = np.linalg.norm(full_t[:, 48:] - x[:, 48:]) / np.linalg.norm(x[:, 48:])
    assert rel < 0.05
    np.testing.assert_allclose(full_t, full_j, atol=1e-3 * np.abs(full_j).max())


@pytest.mark.parametrize("max_iter", [0, 30])
def test_optdmd_from_svd_with_alpha0(rng, max_iter):
    """A given alpha0 seeds the LM; max_iter = 0 (the stage's exact
    path) returns alpha0 itself with its least-squares B, in both."""
    x, t, alpha_true = make_linear_system(rng)
    u, s, vt = _svd(x, 4)
    alpha0 = (alpha_true * 1.05).astype(np.complex64)
    res_t = tm.optdmd_from_svd(torch.from_numpy(u), torch.from_numpy(s), torch.from_numpy(vt),
                               torch.from_numpy(t), rank=4, alpha0=alpha0, max_iter=max_iter)
    res_j = jm.optdmd_from_svd(jnp.asarray(u), jnp.asarray(s), jnp.asarray(vt), jnp.asarray(t),
                               rank=4, alpha0=alpha0, max_iter=max_iter)
    np.testing.assert_allclose(res_t.alpha.numpy(), np.asarray(res_j.alpha), atol=1e-4)
    np.testing.assert_allclose(res_t.amplitudes.numpy(), np.asarray(res_j.amplitudes), rtol=1e-3)
    np.testing.assert_allclose(float(res_t.residual), float(res_j.residual), rtol=1e-3, atol=1e-6)
    if max_iter == 0:
        assert res_t.n_iters == int(res_j.n_iters) == 0
        np.testing.assert_array_equal(res_t.alpha.numpy(), alpha0)
    else:
        assert matched_eig_error(res_t.alpha.numpy(), alpha_true) < 5e-3
