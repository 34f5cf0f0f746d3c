"""Parity of the port's streamed forecast with the JAX package's.

``iter_forecast_blocks`` and ``streamed_forecast_scores`` on one fitted
model (a JAX ``DMDResult`` or ``OptDMDResult`` of a known linear system,
handed to the port by ``convert``), at delay d = 1 and d = 2, with and
without the standardization statistics, in row blocks small enough for
several blocks: the assembled field against the JAX blocks and the
one-shot ``undo_preprocessing(rollout(...))`` (float32 GEMMs, held at
1e-5 of max|field|), the scores against the JAX scores (rtol 1e-5).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_05_dmd import make_linear_system

from dmd_era5_tpu import models as jm
from dmd_era5_tpu_torch import convert
from dmd_era5_tpu_torch import models as tm

BLOCK = 40  # rows a block: 96 undelayed rows take three blocks


def _model(kind: str, d: int):
    """A JAX fit on the d-delay embedding of a known system, the same
    model in the port, the sample times and the embedded matrix."""
    rng = np.random.default_rng(7)
    x, t, _ = make_linear_system(rng)
    n = x.shape[1] - d + 1
    x_emb = np.concatenate([x[:, j : j + n] for j in range(d)], axis=0)
    t = t[:n]
    if kind == "exact":
        res_j = jm.exact_dmd(jnp.asarray(x_emb), rank=4, dt=float(t[1] - t[0]))
        res_t = convert.dmd_result_from_numpy(*(np.asarray(a) for a in res_j[:4]), res_j.dt,
                                              device="cpu")
    else:
        res_j = jm.fit_optdmd(jnp.asarray(x_emb), jnp.asarray(t), rank=4)
        res_t = convert.optdmd_result_from_numpy(*res_j, device="cpu")
    return res_j, res_t, t, x_emb


def _stats(n_rows: int, d: int, with_stats: bool):
    if not with_stats:
        return None, None
    rng = np.random.default_rng(3)
    mean = np.tile(rng.normal(250, 10, n_rows // d), d).astype(np.float32)
    std = np.tile(rng.uniform(0.5, 3.0, n_rows // d), d).astype(np.float32)
    return mean, std


CASES = [(kind, d, stats) for kind in ("exact", "optimized") for d in (1, 2)
         for stats in (False, True)]
IDS = [f"{k}-d{d}-{'stats' if s else 'raw'}" for k, d, s in CASES]


@pytest.mark.parametrize("kind,d,with_stats", CASES, ids=IDS)
def test_iter_forecast_blocks(kind, d, with_stats):
    res_j, res_t, t, x_emb = _model(kind, d)
    mean, std = _stats(x_emb.shape[0], d, with_stats)
    t_all = np.concatenate([t, t[-1] + (t[1] - t[0]) * np.arange(1, 13)]).astype(np.float32)
    blocks = list(tm.iter_forecast_blocks(res_t, t_all, mean, std, delay=d, block_rows=BLOCK))
    blocks_j = list(jm.iter_forecast_blocks(res_j, t_all, mean, std, delay=d, block_rows=BLOCK))
    assert [s0 for s0, _ in blocks] == [s0 for s0, _ in blocks_j] == [0, 40, 80]
    assert all(isinstance(b, torch.Tensor) and b.dtype == torch.float32 for _, b in blocks)
    field = torch.cat([b for _, b in blocks]).numpy()
    field_j = np.concatenate([b for _, b in blocks_j])
    one_shot = tm.undo_preprocessing(
        tm.rollout(res_t, torch.from_numpy(t_all)),
        None if mean is None else torch.from_numpy(mean),
        None if std is None else torch.from_numpy(std), delay=d,
    ).numpy()
    assert field.shape == (x_emb.shape[0] // d, len(t_all))
    scale = np.abs(field_j).max()
    np.testing.assert_allclose(field, field_j, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(field, one_shot, rtol=0, atol=1e-5 * scale)
    # over the training window the undelayed rows reconstruct the system
    undelayed = x_emb[(d - 1) * (x_emb.shape[0] // d):]
    if std is not None:
        undelayed = undelayed * std[: len(undelayed), None]
    if mean is not None:
        undelayed = undelayed + mean[: len(undelayed), None]
    window = field[:, : len(t)]
    assert np.linalg.norm(window - undelayed) / np.linalg.norm(undelayed) < 1e-2


def test_default_block_rows_is_one_block_here():
    _, res_t, t, _ = _model("optimized", 1)
    assert [s0 for s0, _ in tm.iter_forecast_blocks(res_t, t)] == [0]


@pytest.mark.parametrize("kind,d,with_stats", CASES, ids=IDS)
def test_streamed_forecast_scores(kind, d, with_stats):
    res_j, res_t, t, x_emb = _model(kind, d)
    mean, std = _stats(x_emb.shape[0], d, with_stats)
    n_out = x_emb.shape[0] // d
    rng = np.random.default_rng(5)
    t_leads = (t[-1] + (t[1] - t[0]) * np.arange(1, 7)).astype(np.float32)
    truth = np.asarray(jm.undo_preprocessing(jm.rollout(res_j, jnp.asarray(t_leads)),
                                             mean, std, delay=d))
    truth = (truth + 0.05 * np.abs(truth).max() * rng.standard_normal(truth.shape)).astype(np.float32)
    lat = rng.uniform(-80, 80, n_out).astype(np.float32)
    clim = truth.mean(axis=1) + 0.1
    for climatology in (None, clim):
        got = tm.streamed_forecast_scores(res_t, t_leads, truth, latitudes=lat, mean=mean,
                                          std=std, delay=d, climatology=climatology,
                                          block_rows=BLOCK)
        want = jm.streamed_forecast_scores(res_j, t_leads, truth, latitudes=lat, mean=mean,
                                           std=std, delay=d, climatology=climatology,
                                           block_rows=BLOCK)
        one_shot = tm.forecast_scores(
            np.concatenate([b.numpy() for _, b in
                            tm.iter_forecast_blocks(res_t, t_leads, mean, std, delay=d)]),
            truth, lat, climatology)
        for key in ("rmse", "acc", "bias"):
            assert got[key].shape == (6,) and got[key].dtype == np.float32
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6 * np.abs(truth).max())
            np.testing.assert_allclose(got[key], one_shot[key], rtol=1e-5,
                                       atol=1e-6 * np.abs(truth).max())
    with pytest.raises(ValueError, match="one latitude per space row"):
        tm.streamed_forecast_scores(res_t, t_leads, truth, latitudes=lat[:10], delay=d)
