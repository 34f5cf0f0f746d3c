"""Parity of the port's per-variable ensemble with the JAX package's.

tests/test_14_ensemble.py's three fitting cases: one FieldSet (the
port's mock, handed to the JAX package in its own containers) and one
Gaussian sketch (the JAX package's, drawn from ``jax.random`` and passed
to the port) through ``dmd_era5_tpu.pipeline.ensemble`` on its CPU mesh
and the port's ``fit_per_variable_level`` on the CPU, member by member.
The singular values agree to 1e-4 relative (two f32 orders of the same
sums), each member's U is orthonormal to 2e-3 (test_14), and s lies
within 5e-2 of an independent host SVD (test_14).  The batched optDMD is
held to the port's per-member ``optdmd_from_svd`` at test_14's
tolerances (eigenvalues also within 1e-3 relative: see the case); on the i.i.d.-noise mock the optimized fits of the two
packages stop at different points (ROADMAP Queue 3), so it is held to
the JAX package's on planted dynamics (two damped travelling waves per
member, 1% noise): eigenvalues matched to 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_io_h5 import to_jax
from test_torch_optdmd import _match

from dmd_era5_tpu.parallel import make_mesh
from dmd_era5_tpu.pipeline.ensemble import fit_per_variable_level as fit_jax
from dmd_era5_tpu_torch.models import optdmd_from_svd
from dmd_era5_tpu_torch.pipeline import fit_per_variable_level
from dmd_era5_tpu_torch.pipeline.era5_dmd import _hours_since_start
from dmd_era5_tpu_torch.snapmat import create_mock_era5


def _omega(fs, k, seed, n_oversamples=10):
    """The JAX package's sketch for this ensemble (its seed's draw)."""
    return np.asarray(jax.random.normal(jax.random.key(seed),
                                        (fs.sizes["time"], k + n_oversamples), jnp.float32))


def _both(fs, k, mesh, seed=0, **kw):
    port = fit_per_variable_level(fs, n_components=k, seed=seed, device="cpu",
                                  omega=_omega(fs, k, seed), **kw)
    return port, fit_jax(to_jax(fs), n_components=k, mesh=make_mesh(mesh), seed=seed, **kw)


def _planted(fs):
    """Each field replaced by two damped travelling waves (per level a
    phase of its own) plus 1% noise: rank 4 a member."""
    t = np.arange(fs.sizes["time"], dtype=np.float64)
    lat = np.deg2rad(fs.coord("latitude").values.astype(np.float64))[:, None]
    lon = np.deg2rad(fs.coord("longitude").values.astype(np.float64))[None, :]
    rng = np.random.default_rng(3)
    for name in fs.variables:
        field = fs[name]  # (time, level, lat, lon)
        sig = np.zeros(field.shape)
        for li in range(field.shape[1]):
            for freq, damp, klon in ((0.35, 0.005, 1), (0.8, 0.02, 3)):
                phase = freq * t[:, None, None] - klon * lon[None] + 0.7 * li
                pattern = np.cos(lat)[None] * np.cos(phase) + np.sin(2 * lat)[None] * np.sin(phase)
                sig[:, li] += np.exp(-damp * t)[:, None, None] * pattern
        field.data = (250.0 + 10.0 * sig + 0.1 * rng.standard_normal(sig.shape)).astype(np.float32)
    return fs


def _assert_states_match(port, ref):
    s, s_j = port.state.s.numpy(), np.asarray(ref.state.s)
    np.testing.assert_allclose(s, s_j, rtol=1e-4)
    assert port.labels == ref.labels


def test_fit_per_variable_level_labels_and_shapes():
    fs = create_mock_era5("2020-01-01", "2020-01-01T23", ["temperature", "u_component_of_wind"],
                          [1000, 850, 500], seed=4)
    fit, fit_j = _both(fs, 4, "data=2,space=4")
    assert len(fit.labels) == 6
    assert fit.labels[0] == ("temperature", 1000) and fit.labels[3] == ("u_component_of_wind", 1000)
    assert fit.state.u.shape == (6, 36 * 72, 4)
    assert fit.state.s.shape == (6, 4) and fit.state.a_red.shape == (6, 4, 4)
    assert fit.state.v.shape == (6, 4, 24) and fit.state.loss.shape == ()
    for b in range(6):
        u = fit.state.u[b].numpy()
        np.testing.assert_allclose(u.T @ u, np.eye(4), atol=2e-3)
    _assert_states_match(fit, fit_j)
    np.testing.assert_allclose(float(fit.state.loss), float(fit_j.state.loss), rtol=1e-4)


def test_fit_per_variable_level_matches_separate_fits():
    fs = create_mock_era5("2020-01-01", "2020-01-01T23", ["temperature"], [1000, 500], seed=6)
    fit, fit_j = _both(fs, 3, "data=2,space=2", seed=9)
    arr = fs["temperature"].transpose("time", "level", "latitude", "longitude").values
    for li in range(2):
        x = arr[:, li].reshape(arr.shape[0], -1).T
        xc = x - x.mean(axis=1, keepdims=True)
        s_host = np.linalg.svd(xc, compute_uv=False)[:3]
        np.testing.assert_allclose(fit.state.s[li].numpy(), s_host, rtol=5e-2)
    _assert_states_match(fit, fit_j)
    # the seed draws the port's own sketch: a valid fit, not the JAX one's
    own = fit_per_variable_level(fs, n_components=3, seed=9, device="cpu")
    np.testing.assert_allclose(own.state.s.numpy(), fit.state.s.numpy(), rtol=5e-2)


@pytest.mark.parametrize("data", ["mock", "planted"])
def test_fit_per_variable_level_solve_dmd(data):
    """solve_dmd: every member through one batched LM, equal to the
    per-member optdmd_from_svd; on planted dynamics equal to the JAX
    package's batched solve."""
    fs = create_mock_era5("2020-01-01", "2020-01-01T23", ["temperature"], [1000, 500], seed=6)
    k = 3 if data == "mock" else 4
    if data == "planted":
        fs = _planted(fs)
    fit, fit_j = _both(fs, k, "data=2,space=2", seed=9, solve_dmd=True, dmd_max_iter=15)
    dmd = fit.dmd
    assert dmd.alpha.shape == (2, k) and dmd.modes.shape == (2, 36 * 72, k)
    assert dmd.amplitudes.shape == (2, k) and bool((dmd.residual >= 0).all())
    t_hours = _hours_since_start(np.asarray(fs.coord("time").values))
    for b in range(2):
        solo = optdmd_from_svd(fit.state.u[b], fit.state.s[b], fit.state.v[b],
                               torch.from_numpy(t_hours), max_iter=15)
        got = dmd.alpha[b].numpy()
        idx = _match(got, solo.alpha.numpy())
        # atol as test_14; rtol for a mode the LM drove off on noise
        # (|alpha| ~ 2e5 on the mock), where the batched products, rounded
        # otherwise than a batch of one's, leave it 2.5e-4 apart
        np.testing.assert_allclose(got[idx], solo.alpha.numpy(), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(dmd.amplitudes[b].numpy()[idx], solo.amplitudes.numpy(),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(float(dmd.residual[b]), float(solo.residual), atol=1e-5)
        np.testing.assert_allclose(dmd.modes[b].numpy()[:, idx], solo.modes.numpy(), atol=1e-5)
    if data == "planted":
        for b in range(2):
            got, ref = dmd.alpha[b].numpy(), np.asarray(fit_j.dmd.alpha[b])
            idx = _match(got, ref)
            np.testing.assert_allclose(got[idx], ref, atol=1e-4)
            np.testing.assert_allclose(dmd.amplitudes[b].numpy()[idx],
                                       np.asarray(fit_j.dmd.amplitudes[b]), rtol=1e-3)
        np.testing.assert_allclose(dmd.residual.numpy(), np.asarray(fit_j.dmd.residual),
                                   rtol=1e-2)
