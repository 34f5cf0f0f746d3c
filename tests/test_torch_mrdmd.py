"""Parity of the port's mrDMD with the JAX package's.

The scale-separated signals of tests/test_26_mrdmd.py (a slow and a fast
oscillation pair, transients in parts of the time range), as the same
numpy arrays, through ``dmd_era5_tpu.models.mrdmd`` and the port's
counterpart on the CPU, at test_26's tolerances.  Eigenvalues are
compared as matched sets per window (nearest first, without
replacement), never as ``np.sort_complex`` orders: that sorts by real
part first, and where the real parts are 1e-7 noise it pairs +-0.2j
with +-6j.  Amplitudes are compared by modulus (a mode's phase is the
eigenvector's gauge).  The port's Gram route (``fit_mrdmd_gram``) is held
to its ``fit_mrdmd`` on the same X, and its streamed route to the
in-memory one over a packed file.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_26_mrdmd import _two_scale_signal, _wave
from test_torch_optdmd import _match

from dmd_era5_tpu.models import mrdmd as mrdmd_jax
from dmd_era5_tpu.snapmat.loader import save_packed_matrix as save_packed_jax
from dmd_era5_tpu_torch.models import exact_dmd, mrdmd, reconstruct
from dmd_era5_tpu_torch.snapmat.loader import save_packed_matrix

KW = dict(rank=6, max_levels=3, max_cycles=2.0)


def assert_levels_match(got, ref, atol=5e-3, amp_rtol=1e-3):
    """Per window: eigenvalues matched within ``atol``, the matched
    amplitudes' moduli within ``amp_rtol`` of the level's largest, equal
    slow and kept counts."""
    assert got.t_used == ref.t_used and len(got.levels) == len(ref.levels)
    for lv, lv_ref in zip(got.levels, ref.levels):
        assert lv.t_window == lv_ref.t_window and lv.omega.shape == lv_ref.omega.shape
        scale = max(np.abs(lv_ref.amplitudes).max(), 1e-30)
        for w in range(lv_ref.omega.shape[0]):
            idx = _match(lv.omega[w], lv_ref.omega[w])
            np.testing.assert_allclose(lv.omega[w][idx], lv_ref.omega[w], rtol=0, atol=atol)
            np.testing.assert_allclose(np.abs(lv.amplitudes[w][idx]),
                                       np.abs(lv_ref.amplitudes[w]), rtol=0,
                                       atol=amp_rtol * scale)
        assert lv.slow_mask.sum() == lv_ref.slow_mask.sum()
        assert lv.kept_mask.sum() == lv_ref.kept_mask.sum()


def _fit_both(x, dt, **kw):
    return mrdmd.fit_mrdmd(x, dt=dt, device="cpu", **kw), mrdmd_jax.fit_mrdmd(x, dt=dt, **kw)


def test_reconstruction_identity_and_residual_decay():
    x, dt = _two_scale_signal()
    res, res_j = _fit_both(x, dt, **KW)
    assert res.t_used == x.shape[1]
    assert isinstance(res.residual, torch.Tensor) and isinstance(res.levels[0].modes, torch.Tensor)
    recon = mrdmd.mrdmd_reconstruct(res).numpy()
    np.testing.assert_allclose(recon, x[:, : res.t_used] - res.residual.numpy(), rtol=1e-4,
                               atol=5e-3)
    rel = np.linalg.norm(res.residual.numpy()) / np.linalg.norm(x)
    assert rel < 0.05, rel
    np.testing.assert_allclose(res.residual_fro, np.linalg.norm(res.residual.numpy()), rtol=1e-5)
    # both packages reconstruct the same slow parts (the residual is noise)
    np.testing.assert_allclose(recon, mrdmd_jax.mrdmd_reconstruct(res_j), rtol=0,
                               atol=5e-3 * np.abs(x).max())
    np.testing.assert_allclose(res.residual_fro, res_j.residual_fro, rtol=2e-2,
                               atol=1e-3 * np.linalg.norm(x))
    assert_levels_match(res, res_j)


def test_scale_separation_across_levels():
    x, dt = _two_scale_signal()
    res, res_j = _fit_both(x, dt, **KW)
    lv0 = res.levels[0]
    active = np.abs(lv0.amplitudes[0]) > 1e-2 * np.abs(lv0.amplitudes).max()
    omegas0 = lv0.omega[0][active]
    assert omegas0.size > 0
    assert np.all(np.abs(omegas0) <= 0.5 + 1e-6)
    freqs0 = np.abs(np.imag(omegas0))
    assert np.any(np.abs(freqs0 - 0.2) < 0.05), freqs0
    assert not np.any(np.abs(freqs0 - 6.0) < 1.0)
    found = False
    for lv in res.levels[1:]:
        for win in range(lv.omega.shape[0]):
            act = np.abs(lv.amplitudes[win]) > 1e-3
            if np.any(np.abs(np.abs(np.imag(lv.omega[win][act])) - 6.0) < 0.5):
                found = True
    assert found
    assert_levels_match(res, res_j)


def test_transient_localization():
    """A burst in the second half lands in the level-1 second window."""
    rng = np.random.default_rng(1)
    s_rows, t_total, dt = 64, 256, 0.1
    t = np.arange(t_total) * dt
    x = _wave(rng, s_rows, t, 0.15, 1.5)
    half = t_total // 2
    burst = np.zeros((s_rows, t_total))
    burst[:, half:] = _wave(rng, s_rows, t[:half], 4.0, 1.0)
    x = (x + burst).astype(np.float32)
    res, res_j = _fit_both(x, dt, rank=6, max_levels=2, max_cycles=2.0)
    lv1 = res.levels[1]
    e_first, e_second = np.linalg.norm(lv1.amplitudes[0]), np.linalg.norm(lv1.amplitudes[1])
    active = np.abs(lv1.amplitudes[1]) > 1e-2 * max(e_second, 1e-30)
    assert np.any(np.abs(np.abs(np.imag(lv1.omega[1]))[active] - 4.0) < 0.5)
    assert e_second > 3.0 * e_first, (e_first, e_second)
    assert_levels_match(res, res_j)


def test_beats_single_window_dmd_on_transients():
    rng = np.random.default_rng(2)
    s_rows, t_total, dt = 64, 256, 0.1
    t = np.arange(t_total) * dt
    x = _wave(rng, s_rows, t, 0.1, 1.0)
    for q, w in enumerate((1.5, 3.0, 5.0, 8.0)):
        seg = slice(q * 64, (q + 1) * 64)
        x[:, seg] += _wave(rng, s_rows, t[:64], w, 1.0)
    x = x.astype(np.float32)
    res, res_j = _fit_both(x, dt, **KW)
    err_mr = res.residual_fro / np.linalg.norm(x)
    d = exact_dmd(torch.from_numpy(x), rank=6, dt=dt)
    err_dmd = np.linalg.norm(x - reconstruct(d, t_total).numpy()) / np.linalg.norm(x)
    assert err_mr < 0.5 * err_dmd, (err_mr, err_dmd)
    np.testing.assert_allclose(err_mr, res_j.residual_fro / np.linalg.norm(x), rtol=2e-2,
                               atol=1e-3)


def test_validation_and_no_modes_paths():
    x, dt = _two_scale_signal(t_total=64)
    with pytest.raises(ValueError, match="finest window"):
        mrdmd.fit_mrdmd(x, dt=dt, rank=6, max_levels=5, device="cpu")
    res = mrdmd.fit_mrdmd(x, dt=dt, rank=4, max_levels=2, return_modes=False, device="cpu")
    assert res.levels[0].modes is None
    with pytest.raises(ValueError, match="return_modes"):
        mrdmd.mrdmd_reconstruct(res)
    assert res.levels[1].omega.shape == (2, 4)
    assert_levels_match(res, mrdmd_jax.fit_mrdmd(x, dt=dt, rank=4, max_levels=2,
                                                 return_modes=False))


def test_time_truncation():
    x, dt = _two_scale_signal(t_total=250)  # no multiple of 4
    res, res_j = _fit_both(x, dt, rank=4, max_levels=3)
    assert res.t_used == 248 and tuple(res.residual.shape) == (x.shape[0], 248)
    assert_levels_match(res, res_j)


def test_from_svd_subspace_bias_vs_raw_oracle():
    """The subspace route is blind to a weak transient outside the global
    top-4 POD modes, the raw refit is not (test_26's construction), in
    both packages alike."""
    rng = np.random.default_rng(0)
    s_rows, t_total = 256, 128
    q_all, _ = np.linalg.qr(rng.standard_normal((s_rows, 6)))
    t = np.arange(t_total, dtype=np.float64)
    x = np.zeros((s_rows, t_total))
    for j, (freq, amp) in enumerate(((0.05, 1.0), (0.11, 0.8))):
        x += amp * np.outer(q_all[:, 2 * j], np.cos(freq * t))
        x += amp * np.outer(q_all[:, 2 * j + 1], np.sin(freq * t))
    win = slice(64, 96)
    tw = t[win] - 64.0
    transient = 0.05 * (np.outer(q_all[:, 4], np.cos(1.2 * tw))
                        + np.outer(q_all[:, 5], np.sin(1.2 * tw)))
    x_tr = x.copy()
    x_tr[:, win] += transient
    x_tr = x_tr.astype(np.float32)
    uu, ss, vvt = np.linalg.svd(x_tr, full_matrices=False)
    k = 4
    assert np.linalg.norm(uu[:, :k].T @ q_all[:, 4:6]) < 0.3
    kw = dict(dt=1.0, max_levels=3, max_cycles=2.0)
    factors = [np.ascontiguousarray(a) for a in (uu[:, :k], ss[:k], vvt[:k])]
    res_raw = mrdmd.fit_mrdmd(x_tr, rank=4, device="cpu", **kw)
    res_sub = mrdmd.mrdmd_from_svd(*(torch.from_numpy(a) for a in factors), rank=4, **kw)
    tr_norm = np.linalg.norm(transient)
    err = {}
    for name, res in (("raw", res_raw), ("sub", res_sub)):
        err[name] = np.linalg.norm((mrdmd.mrdmd_reconstruct(res).numpy() - x_tr)[:, win]) / tr_norm
    assert err["raw"] < 0.25, err
    assert 0.8 < err["sub"] < 1.5, err
    res_sub_j = mrdmd_jax.mrdmd_from_svd(*factors, rank=4, **kw)
    err_sub_j = np.linalg.norm((mrdmd_jax.mrdmd_reconstruct(res_sub_j) - x_tr)[:, win]) / tr_norm
    np.testing.assert_allclose(err["sub"], err_sub_j, rtol=1e-3)
    np.testing.assert_allclose(mrdmd.mrdmd_reconstruct(res_sub).numpy(),
                               mrdmd_jax.mrdmd_reconstruct(res_sub_j), rtol=0,
                               atol=1e-3 * np.abs(x_tr).max())
    # level 0 holds the slow pairs; below it the subspace residual is
    # roundoff, whose spectra no two fits share
    assert_levels_match(res_sub._replace(levels=res_sub.levels[:1]),
                        res_sub_j._replace(levels=res_sub_j.levels[:1]))
    # lifted modes: unit columns in full space, amplitudes carry the norms
    for lv in res_sub.levels:
        norms = torch.linalg.vector_norm(lv.modes, dim=1).numpy()
        live = np.abs(lv.amplitudes) > 0
        np.testing.assert_allclose(norms[live], 1.0, rtol=1e-5)


def test_gram_route_matches_device_route():
    """fit_mrdmd_gram(X^T X) against the port's fit_mrdmd(X), eigenvalues
    matched (the JAX test's sort_complex order pairs the wrong ones here);
    and the port's Gram route against the JAX package's, the same f64
    algebra."""
    x, dt = _two_scale_signal()
    ref = mrdmd.fit_mrdmd(x, dt=dt, device="cpu", **KW)
    gx = x.astype(np.float64).T @ x.astype(np.float64)
    got = mrdmd.fit_mrdmd_gram(gx, dt=dt, **KW)
    assert got.residual is None and all(lv.mode_map is not None for lv in got.levels)
    assert_levels_match(got, ref, amp_rtol=1e-2)
    np.testing.assert_allclose(got.residual_fro, ref.residual_fro, rtol=2e-2,
                               atol=1e-3 * np.linalg.norm(x))
    np.testing.assert_allclose(got.x_fro, np.linalg.norm(x.astype(np.float64)), rtol=1e-12)
    got_j = mrdmd_jax.fit_mrdmd_gram(gx, dt=dt, **KW)
    assert_levels_match(got, got_j, atol=1e-9, amp_rtol=1e-9)
    np.testing.assert_allclose(got.residual_fro, got_j.residual_fro, rtol=1e-12)


@pytest.mark.parametrize("suffix", [".h5", ".npy"])
def test_streamed_mrdmd_from_packed_file(tmp_path, suffix):
    """fit_mrdmd_streamed: one Gram pass over the packed artifact and a
    mode pass; its reconstruction matches the in-memory route's, the
    artifact written by the JAX package (HDF5) or the port (.npy)."""
    x, dt = _two_scale_signal()
    path = tmp_path / f"x{suffix}"
    (save_packed_jax if suffix == ".h5" else save_packed_matrix)(path, x, d=1)
    ref = mrdmd.fit_mrdmd(x, dt=dt, device="cpu", **KW)
    got = mrdmd.fit_mrdmd_streamed(path, dt=dt, block_rows=17, return_modes=True, device="cpu",
                                   **KW)
    scale = np.linalg.norm(x)
    rec = mrdmd.mrdmd_reconstruct(got).numpy()
    assert np.linalg.norm(rec - mrdmd.mrdmd_reconstruct(ref).numpy()) / scale < 2e-2
    np.testing.assert_allclose(got.residual_fro / scale, ref.residual_fro / scale, atol=2e-2)
    # the modes are X @ mode_map, blockwise
    lv = got.levels[1]
    np.testing.assert_allclose(lv.modes.numpy(), x @ lv.mode_map, rtol=0, atol=1e-4)
    if suffix == ".h5":
        got_j = mrdmd_jax.fit_mrdmd_streamed(path, dt=dt, block_rows=17, return_modes=True,
                                             **KW)
        assert_levels_match(got, got_j, atol=1e-5, amp_rtol=1e-4)
        np.testing.assert_allclose(rec, mrdmd_jax.mrdmd_reconstruct(got_j), rtol=0,
                                   atol=1e-4 * np.abs(x).max())


def test_gram_route_validation():
    with pytest.raises(ValueError, match="finest window"):
        mrdmd.fit_mrdmd_gram(np.eye(16), rank=8, max_levels=3)
