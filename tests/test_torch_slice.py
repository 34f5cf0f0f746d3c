"""The whole port slice against the whole JAX path, on config.ini defaults.

Mock ERA5 on the 5-degree grid, 2019-01-01T00 to 2019-01-05T00 (97
hourly snapshots), temperature at 1000 hPa, mean-centred (scale off);
randomized Hankel SVD at d = 2 and 10 components in float32; optDMD at
rank 6 with the LM capped at 50 steps; a 24-step forecast.  The mock
recipe is i.i.d. noise, which leaves optDMD's eigenvalues ill-determined,
so three damped oscillating pairs (6 eigenvalues) are planted on top.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_05_dmd import matched_eig_error

from dmd_era5_tpu.models import forecast_times, optdmd_from_svd, rollout, undo_preprocessing
from dmd_era5_tpu.ops.hankel import hankel_randomized_svd_fused
from dmd_era5_tpu.snapmat import create_mock_era5, flatten_era5_variables, standardize_data
from dmd_era5_tpu_torch import convert
from dmd_era5_tpu_torch import models as tm
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


def test_slice_matches_jax_path():
    fs = create_mock_era5("2019-01-01T00", "2019-01-05T00", ["temperature"], [1000], seed=0)
    field = fs["temperature"]
    n_time = field.data.shape[0]
    assert n_time == 97
    hours = np.arange(n_time, dtype=np.float64)
    signal = _planted(field.data[0].size, hours, np.random.default_rng(1))
    field.data[...] += signal.reshape(field.data.shape)

    # ---- the JAX path (the pipeline's stage defaults)
    raw = np.asarray(flatten_era5_variables(fs).data)  # (S, T) float64
    fs_c, mean_fs, _ = standardize_data(fs, scale=False)
    x = np.asarray(flatten_era5_variables(fs_c).data, dtype=np.float32)
    s_rows = x.shape[0]
    svd_j = hankel_randomized_svd_fused(jnp.asarray(x), D, K, gemm_dtype=jnp.float32)
    t_fit = hours[D - 1 :].astype(np.float32) - hours[D - 1]  # hours since start
    opt_j = optdmd_from_svd(svd_j.U, svd_j.s, svd_j.V, jnp.asarray(t_fit), rank=RANK)
    mean_row = np.asarray(flatten_era5_variables(mean_fs).data).reshape(-1)
    mean_emb = np.tile(mean_row, D).astype(np.float32)
    t_all = np.asarray(forecast_times(len(t_fit), STEPS, 1.0))
    fc_j = np.asarray(undo_preprocessing(
        rollout(opt_j, jnp.asarray(t_all)), jnp.asarray(mean_emb), None, delay=D
    ))

    # ---- the port: the same raw matrix, the same Gaussian sketch
    xc_t, mean_t, _ = standardize_torch(torch.from_numpy(raw), scale=False)
    np.testing.assert_allclose(xc_t.numpy(), x, rtol=0, atol=1e-4)
    omega = np.array(jax.random.normal(jax.random.key(0), (n_time - D + 1, K + 28)))
    svd_t = hankel_randomized_svd_fused_core(
        xc_t.float(), D, K, torch.from_numpy(omega), gemm_dtype=torch.float32
    )
    opt_t = tm.optdmd_from_svd(*svd_t, torch.from_numpy(t_fit), rank=RANK)
    mean_emb_t = mean_t.float().repeat(D)
    fc_t = tm.undo_preprocessing(
        tm.rollout(opt_t, tm.forecast_times(len(t_fit), STEPS, 1.0)), mean_emb_t, None, delay=D
    ).numpy()

    # SVD: one sketch, so every iterate is shared (test_08_kernels.py:147-153)
    np.testing.assert_allclose(svd_t.s.numpy(), np.asarray(svd_j.s), rtol=1e-4)
    np.testing.assert_allclose(svd_t.U.numpy(), np.asarray(svd_j.U), atol=1e-3)
    np.testing.assert_allclose(svd_t.V.numpy(), np.asarray(svd_j.V), atol=1e-3)
    assert svd_t.U.shape == (D * s_rows, K)

    # optDMD: both recover the planted spectrum (test_05_dmd.py metric);
    # the two f32 LM runs start from one init on inputs equal to ~1e-6,
    # and agree to 1e-3 in eigenvalues and relative amplitudes
    a_t, a_j = opt_t.alpha.numpy(), np.asarray(opt_j.alpha)
    assert matched_eig_error(a_t, ALPHA_TRUE) < 1e-2
    assert matched_eig_error(a_j, ALPHA_TRUE) < 1e-2
    idx = [int(np.argmin(np.abs(a_t - a))) for a in a_j]
    assert sorted(idx) == list(range(RANK))
    np.testing.assert_allclose(a_t[idx], a_j, atol=1e-3)
    np.testing.assert_allclose(
        opt_t.amplitudes.numpy()[idx], np.asarray(opt_j.amplitudes), rtol=1e-3
    )

    # the JAX SVD artifact, carried across, feeds the port's optDMD:
    # identical inputs, so only the two LM implementations differ
    opt_c = tm.optdmd_from_svd(
        *convert.svd_result_from_numpy(svd_j.U, svd_j.s, svd_j.V),
        torch.from_numpy(t_fit), rank=RANK,
    )
    a_c = opt_c.alpha.numpy()
    np.testing.assert_allclose(a_c[[int(np.argmin(np.abs(a_c - a))) for a in a_j]], a_j, atol=1e-4)

    # forecast (physical units, undelayed block): the anomaly about the
    # row mean agrees to 1e-3 of its norm, and the 24 new steps are finite
    assert fc_t.shape == (s_rows, len(t_all)) and np.all(np.isfinite(fc_t))
    anomaly = fc_j - mean_row[:, None]
    assert np.linalg.norm(fc_t - fc_j) / np.linalg.norm(anomaly) < 1e-3
