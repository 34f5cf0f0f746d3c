"""The whole port slice against the whole JAX path.

Mock ERA5 on the 5-degree grid, 2019-01-01T00 to 2019-01-05T00 (97
hourly snapshots), temperature at 1000 hPa, mean-centred (scale off);
the Hankel SVD at d = 2 and 10 components in float32, randomized (the
config.ini default) or exact (``svd_type = standard``); optDMD at rank
6 with the LM capped at 50 steps; a 24-step forecast.  The mock recipe
is i.i.d. noise, which leaves optDMD's eigenvalues ill-determined, so
three damped oscillating pairs (6 eigenvalues) are planted on top.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_05_dmd import matched_eig_error

from dmd_era5_tpu.models import forecast_times, optdmd_from_svd, rollout, undo_preprocessing
from dmd_era5_tpu.ops.hankel import hankel_exact_svd, hankel_randomized_svd_fused
from dmd_era5_tpu.snapmat import create_mock_era5, flatten_era5_variables, standardize_data
from dmd_era5_tpu_torch import convert
from dmd_era5_tpu_torch import models as tm
from dmd_era5_tpu_torch.ops.hankel import hankel_exact_svd as hankel_exact_torch
from dmd_era5_tpu_torch.ops.hankel import hankel_randomized_svd_fused_core
from dmd_era5_tpu_torch.snapmat import standardize_data as standardize_torch

D, K, RANK, STEPS = 2, 10, 6, 24
# planted pairs: damping (1/h), period (h), amplitude (K)
PAIRS = [(-0.01, 24.0, 12.0), (-0.02, 12.0, 8.0), (-0.005, 84.0, 6.0)]
ALPHA_TRUE = np.array(
    [a + s * 2j * np.pi / p for a, p, _ in PAIRS for s in (1, -1)], dtype=np.complex64
)


def _planted(n_space, hours, rng):
    """Sum over pairs of amp * Re(c(row) exp(alpha t)), (time, space)."""
    out = np.zeros((len(hours), n_space))
    for damp, period, amp in PAIRS:
        c = rng.standard_normal(n_space) + 1j * rng.standard_normal(n_space)
        dyn = np.exp((damp + 2j * np.pi / period) * hours)
        out += amp * np.real(np.outer(dyn, c))
    return out


def _mock_slice():
    """(raw (S, T) f64, centred JAX-side x f32, hours, row mean)."""
    fs = create_mock_era5("2019-01-01T00", "2019-01-05T00", ["temperature"], [1000], seed=0)
    field = fs["temperature"]
    n_time = field.data.shape[0]
    assert n_time == 97
    hours = np.arange(n_time, dtype=np.float64)
    signal = _planted(field.data[0].size, hours, np.random.default_rng(1))
    field.data[...] += signal.reshape(field.data.shape)
    raw = np.asarray(flatten_era5_variables(fs).data)  # (S, T) float64
    fs_c, mean_fs, _ = standardize_data(fs, scale=False)
    x = np.asarray(flatten_era5_variables(fs_c).data, dtype=np.float32)
    mean_row = np.asarray(flatten_era5_variables(mean_fs).data).reshape(-1)
    return raw, x, hours, mean_row


def _chains(svd_jax, svd_torch_of):
    """Both paths from the SVD on: (svd_j, opt_j, fc_j, svd_t, opt_t,
    fc_t, t_fit, mean_row), where svd_torch_of(centred x) is the port's
    SVD of the port's own centred matrix."""
    raw, x, hours, mean_row = _mock_slice()
    # ---- the JAX path (the pipeline's stage defaults)
    svd_j = svd_jax(jnp.asarray(x))
    t_fit = hours[D - 1 :].astype(np.float32) - hours[D - 1]  # hours since start
    opt_j = optdmd_from_svd(svd_j.U, svd_j.s, svd_j.V, jnp.asarray(t_fit), rank=RANK)
    mean_emb = np.tile(mean_row, D).astype(np.float32)
    t_all = np.asarray(forecast_times(len(t_fit), STEPS, 1.0))
    fc_j = np.asarray(undo_preprocessing(
        rollout(opt_j, jnp.asarray(t_all)), jnp.asarray(mean_emb), None, delay=D
    ))

    # ---- the port: the same raw matrix
    xc_t, mean_t, _ = standardize_torch(torch.from_numpy(raw), scale=False)
    np.testing.assert_allclose(xc_t.numpy(), x, rtol=0, atol=1e-4)
    svd_t = svd_torch_of(xc_t.float())
    opt_t = tm.optdmd_from_svd(*svd_t, torch.from_numpy(t_fit), rank=RANK)
    mean_emb_t = mean_t.float().repeat(D)
    fc_t = tm.undo_preprocessing(
        tm.rollout(opt_t, tm.forecast_times(len(t_fit), STEPS, 1.0, device="cpu")), mean_emb_t, None, delay=D
    ).numpy()
    assert svd_t.U.shape == (D * x.shape[0], K)
    assert fc_t.shape == (x.shape[0], len(t_all)) and np.all(np.isfinite(fc_t))
    return svd_j, opt_j, fc_j, svd_t, opt_t, fc_t, t_fit, mean_row


def _check_optdmd_and_forecast(opt_j, fc_j, opt_t, fc_t, mean_row):
    """optDMD: both recover the planted spectrum (test_05_dmd.py metric);
    the two f32 LM runs start from one init on inputs equal to ~1e-6, and
    agree to 1e-3 in eigenvalues and relative amplitudes.  Forecast
    (physical units, undelayed block): the anomaly about the row mean
    agrees to 1e-3 of its norm."""
    a_t, a_j = opt_t.alpha.numpy(), np.asarray(opt_j.alpha)
    assert matched_eig_error(a_t, ALPHA_TRUE) < 1e-2
    assert matched_eig_error(a_j, ALPHA_TRUE) < 1e-2
    idx = [int(np.argmin(np.abs(a_t - a))) for a in a_j]
    assert sorted(idx) == list(range(RANK))
    np.testing.assert_allclose(a_t[idx], a_j, atol=1e-3)
    np.testing.assert_allclose(
        opt_t.amplitudes.numpy()[idx], np.asarray(opt_j.amplitudes), rtol=1e-3
    )
    anomaly = fc_j - mean_row[:, None]
    assert np.linalg.norm(fc_t - fc_j) / np.linalg.norm(anomaly) < 1e-3


def test_slice_matches_jax_path():
    n_time = 97
    # the same Gaussian sketch on both sides
    omega = np.array(jax.random.normal(jax.random.key(0), (n_time - D + 1, K + 28)))
    svd_j, opt_j, fc_j, svd_t, opt_t, fc_t, t_fit, mean_row = _chains(
        lambda x: hankel_randomized_svd_fused(x, D, K, gemm_dtype=jnp.float32),
        lambda x: hankel_randomized_svd_fused_core(
            x, D, K, torch.from_numpy(omega), gemm_dtype=torch.float32
        ),
    )

    # SVD: one sketch, so every iterate is shared (test_08_kernels.py:147-153)
    np.testing.assert_allclose(svd_t.s.numpy(), np.asarray(svd_j.s), rtol=1e-4)
    np.testing.assert_allclose(svd_t.U.numpy(), np.asarray(svd_j.U), atol=1e-3)
    np.testing.assert_allclose(svd_t.V.numpy(), np.asarray(svd_j.V), atol=1e-3)
    _check_optdmd_and_forecast(opt_j, fc_j, opt_t, fc_t, mean_row)

    # the JAX SVD artifact, carried across, feeds the port's optDMD:
    # identical inputs, so only the two LM implementations differ
    opt_c = tm.optdmd_from_svd(
        *convert.svd_result_from_numpy(svd_j.U, svd_j.s, svd_j.V, device="cpu"),
        torch.from_numpy(t_fit), rank=RANK,
    )
    a_c, a_j = opt_c.alpha.numpy(), np.asarray(opt_j.alpha)
    np.testing.assert_allclose(a_c[[int(np.argmin(np.abs(a_c - a))) for a in a_j]], a_j, atol=1e-4)


def test_standard_slice_matches_jax_path():
    """``svd_type = standard``: the exact Hankel SVD (bf16-split Gram, one
    fused Rayleigh-Ritz pass) -> optDMD -> forecast on both sides.  The
    exact SVD is deterministic and fixes no signs, so U and V are
    compared up to a sign per component, at the randomized chain's
    tolerances."""
    svd_j, opt_j, fc_j, svd_t, opt_t, fc_t, _, mean_row = _chains(
        lambda x: hankel_exact_svd(x, D, K),
        lambda x: hankel_exact_torch(x, D, K),
    )
    np.testing.assert_allclose(svd_t.s.numpy(), np.asarray(svd_j.s), rtol=1e-4)
    signs = np.sign(np.sum(svd_t.U.numpy() * np.asarray(svd_j.U), axis=0))
    np.testing.assert_allclose(svd_t.U.numpy() * signs, np.asarray(svd_j.U), atol=1e-3)
    np.testing.assert_allclose(svd_t.V.numpy() * signs[:, None], np.asarray(svd_j.V), atol=1e-3)
    _check_optdmd_and_forecast(opt_j, fc_j, opt_t, fc_t, mean_row)
