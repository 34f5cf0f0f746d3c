"""Parity of the port's forecast verification scores with the JAX package.

Every function of ``models/verification.py`` on the same seeded fields
in both packages (float32 one-shot scores at rtol 1e-5), and the
blockwise ``ScoreAccumulator`` against the one-shot scores and against
the JAX accumulator.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.models import verification as vj
from dmd_era5_tpu_torch.models import verification as vt

S, L = 300, 7


@pytest.fixture()
def fields():
    rng = np.random.default_rng(11)
    truth = (250 + 10 * rng.standard_normal((S, L))).astype(np.float32)
    forecast = (truth + rng.standard_normal((S, L)) + 0.3).astype(np.float32)
    lat = rng.uniform(-90, 90, S).astype(np.float32)
    lat[:3] = (90.0, -90.0, 0.0)  # the poles get no weight
    clim = (250 + rng.standard_normal(S)).astype(np.float32)
    return forecast, truth, lat, clim


def test_latitude_weights(fields):
    _, _, lat, _ = fields
    w_t = vt.latitude_weights(lat)
    w_j = np.asarray(vj.latitude_weights(lat))
    assert isinstance(w_t, torch.Tensor) and w_t.dtype == torch.float32
    np.testing.assert_allclose(w_t.numpy(), w_j, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(w_t.mean()), 1.0, rtol=1e-6)
    assert float(w_t[0]) == pytest.approx(0.0, abs=1e-7)


def test_space_weights_need_one_latitude_per_row(fields):
    _, _, lat, _ = fields
    np.testing.assert_allclose(vt._space_weights(lat, S).numpy(),
                               np.asarray(vj._space_weights(lat, S)), rtol=1e-6, atol=1e-7)
    grid_axis = np.linspace(-90, 90, 20)
    for mod in (vt, vj):
        with pytest.raises(ValueError, match="one latitude per space row"):
            mod._space_weights(grid_axis, S)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["weighted_rmse", "weighted_bias", "weighted_acc"])
def test_weighted_scores(fields, name, weighted):
    forecast, truth, lat, _ = fields
    w = vt.latitude_weights(lat) if weighted else None
    w_j = vj.latitude_weights(lat) if weighted else None
    got = getattr(vt, name)(torch.from_numpy(forecast), torch.from_numpy(truth), weights=w)
    want = np.asarray(getattr(vj, name)(jnp.asarray(forecast), jnp.asarray(truth), weights=w_j))
    assert got.shape == (L,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_weighted_acc_with_climatology(fields):
    forecast, truth, lat, clim = fields
    got = vt.weighted_acc(forecast, truth, climatology=clim, weights=vt.latitude_weights(lat))
    want = vj.weighted_acc(forecast, truth, climatology=clim, weights=vj.latitude_weights(lat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    perfect = vt.weighted_acc(truth, truth)
    np.testing.assert_allclose(perfect.numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("with_lat", [False, True])
def test_forecast_scores(fields, with_lat):
    forecast, truth, lat, _ = fields
    latitudes = lat if with_lat else None
    got = vt.forecast_scores(torch.from_numpy(forecast), torch.from_numpy(truth), latitudes)
    want = vj.forecast_scores(forecast, truth, latitudes)
    assert set(got) == {"rmse", "acc", "bias"}
    for key in got:
        assert isinstance(got[key], np.ndarray) and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("clim", [False, True], ids=["centred", "climatology"])
@pytest.mark.parametrize("block", [S, 64, 7])
def test_score_accumulator_blockwise_equals_one_shot(fields, block, clim):
    """Row blocks through ``update`` give the one-shot scores, and the
    JAX accumulator's on the same blocks (both sum in float64)."""
    forecast, truth, lat, c = fields
    w = vt.latitude_weights(lat).numpy()
    acc_t, acc_j = vt.ScoreAccumulator(), vj.ScoreAccumulator()
    for s0 in range(0, S, block):
        s1 = min(s0 + block, S)
        c_blk = c[s0:s1] if clim else None
        acc_t.update(torch.from_numpy(forecast[s0:s1]), torch.from_numpy(truth[s0:s1]),
                     torch.from_numpy(w[s0:s1]), None if c_blk is None else torch.from_numpy(c_blk))
        acc_j.update(forecast[s0:s1], truth[s0:s1], w[s0:s1], c_blk)
    got, want = acc_t.finalize(), acc_j.finalize()
    one_shot = vt.forecast_scores(forecast, truth, lat, c if clim else None)
    for key in ("rmse", "acc", "bias"):
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[key], one_shot[key], rtol=1e-5, atol=1e-6)


def test_score_accumulator_needs_a_block():
    with pytest.raises(ValueError, match="No blocks"):
        vt.ScoreAccumulator().finalize()
