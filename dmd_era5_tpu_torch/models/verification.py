"""Forecast verification: latitude-weighted RMSE, ACC and bias.

PyTorch counterpart of ``dmd_era5_tpu/models/verification.py``: the
scores every NWP and ML-weather paper reports (cf. WeatherBench), per
lead time, on (space, lead) fields.  Grid cells shrink as
cos(latitude), so rows are weighted by normalized cos(latitude),
clipped at 0 (a pole on a cell-centre grid has no area).

The functions take tensors (or arrays) and return tensors on the
forecast's device; :func:`forecast_scores` and
:meth:`ScoreAccumulator.finalize` return host numpy float32, as the JAX
package's do.  :class:`ScoreAccumulator` sums row blocks in float64 on
the blocks' device, so the stage scores an S-row holdout with O(block)
residency.
"""

from __future__ import annotations

import numpy as np
import torch

from dmd_era5_tpu_torch.utils.tensors import as_tensor

__all__ = [
    "latitude_weights",
    "weighted_rmse",
    "weighted_acc",
    "weighted_bias",
    "forecast_scores",
    "ScoreAccumulator",
]


def _f32(a, device=None) -> torch.Tensor:
    return as_tensor(a, torch.float32, device)


def _f64(a, device=None) -> torch.Tensor:
    return as_tensor(a, torch.float64, device)


def latitude_weights(latitudes, device=None) -> torch.Tensor:
    """Normalized cos(latitude) area weights (degrees in, mean 1 out)."""
    w = torch.clamp(torch.cos(torch.deg2rad(_f32(latitudes, device))), min=0.0)
    return w / torch.mean(w)


def _space_weights(latitudes, n_space: int, device=None) -> torch.Tensor:
    """Per-row weights for a flattened space axis.

    ``latitudes`` must be PER-ROW (len == n_space): the parallel
    ``latitude`` coordinate the stage artifacts carry.  A bare grid axis
    cannot be tiled without the level and longitude counts, so it raises.
    """
    n_lat = len(latitudes)
    if n_lat != n_space:
        raise ValueError(
            f"need one latitude per space row: got {n_lat} for "
            f"{n_space} rows (pass the artifact's per-row 'latitude' "
            "coordinate)"
        )
    return latitude_weights(latitudes, device)


def _weights(f: torch.Tensor, weights) -> torch.Tensor:
    if weights is None:
        return torch.ones(f.shape[0], dtype=torch.float32, device=f.device)
    return _f32(weights, f.device)


def weighted_rmse(forecast, truth, weights=None) -> torch.Tensor:
    """Latitude-weighted RMSE per lead time.

    forecast/truth: (S, L) space x lead; weights: per-row (S,) area
    weights (default uniform).  Returns (L,).
    """
    f = _f32(forecast)
    t = _f32(truth, f.device)
    w = _weights(f, weights)
    se = torch.square(f - t) * w[:, None]
    return torch.sqrt(torch.sum(se, dim=0) / torch.sum(w))


def weighted_bias(forecast, truth, weights=None) -> torch.Tensor:
    """Latitude-weighted mean error per lead time, (L,)."""
    f = _f32(forecast)
    t = _f32(truth, f.device)
    w = _weights(f, weights)
    return torch.sum((f - t) * w[:, None], dim=0) / torch.sum(w)


def weighted_acc(forecast, truth, climatology=None, weights=None) -> torch.Tensor:
    """Anomaly correlation coefficient per lead time, (L,).

    Anomalies are deviations from ``climatology`` (per-row reference
    state; default: the truth's time mean, the centred-ACC convention).
    """
    f = _f32(forecast)
    t = _f32(truth, f.device)
    w = _weights(f, weights)[:, None]
    clim = torch.mean(t, dim=1) if climatology is None else _f32(climatology, f.device)
    fa = f - clim[:, None]
    ta = t - clim[:, None]
    num = torch.sum(fa * ta * w, dim=0)
    den = torch.sqrt(torch.sum(torch.square(fa) * w, dim=0) * torch.sum(torch.square(ta) * w, dim=0))
    return num / torch.clamp(den, min=1e-30)


class ScoreAccumulator:
    """Blockwise-exact accumulation of :func:`forecast_scores`.

    Every score is a ratio of weighted sums over space, so row blocks
    reduce exactly: (S_blk, L) blocks through :meth:`update`, then
    :meth:`finalize`, give the one-shot scores (float64 sums on the
    blocks' device, at least as accurate as the float32 one-shot).

    ACC climatology: per-row ``clim_blk`` in :meth:`update`, or omitted
    for the centred convention (the truth's row mean, per block, as the
    one-shot default).
    """

    def __init__(self) -> None:
        self._sums: dict[str, torch.Tensor] | None = None
        self._wsum: torch.Tensor | None = None

    def update(self, f_blk, t_blk, w_blk=None, clim_blk=None) -> None:
        f = _f64(f_blk)
        t = _f64(t_blk, f.device)
        w = torch.ones(f.shape[0], dtype=torch.float64, device=f.device) if w_blk is None \
            else _f64(w_blk, f.device)
        clim = t.mean(dim=1) if clim_blk is None else _f64(clim_blk, f.device)
        err = f - t
        fa = f - clim[:, None]
        ta = t - clim[:, None]
        wc = w[:, None]
        upd = {
            "se": torch.sum(torch.square(err) * wc, dim=0),
            "err": torch.sum(err * wc, dim=0),
            "num": torch.sum(fa * ta * wc, dim=0),
            "fa2": torch.sum(torch.square(fa) * wc, dim=0),
            "ta2": torch.sum(torch.square(ta) * wc, dim=0),
        }
        if self._sums is None:
            self._sums, self._wsum = upd, torch.sum(w)
        else:
            for k, v in upd.items():
                self._sums[k] += v
            self._wsum += torch.sum(w)

    def finalize(self) -> dict[str, np.ndarray]:
        if self._sums is None:
            raise ValueError("No blocks accumulated")
        s = {k: v.cpu().numpy() for k, v in self._sums.items()}
        wsum = float(self._wsum)
        rmse = np.sqrt(s["se"] / wsum)
        bias = s["err"] / wsum
        acc = s["num"] / np.maximum(np.sqrt(s["fa2"] * s["ta2"]), 1e-30)
        return {
            "rmse": rmse.astype(np.float32),
            "acc": acc.astype(np.float32),
            "bias": bias.astype(np.float32),
        }


def forecast_scores(
    forecast,
    truth,
    latitudes=None,
    climatology=None,
) -> dict[str, np.ndarray]:
    """All scores at once: {'rmse', 'acc', 'bias'}, each (L,) host numpy.

    forecast/truth: (S, L).  ``latitudes``: per-row degrees (see
    :func:`_space_weights`); None = unweighted.
    """
    f = _f32(forecast)
    w = None if latitudes is None else _space_weights(latitudes, f.shape[0], f.device)
    return {
        "rmse": weighted_rmse(f, truth, w).cpu().numpy(),
        "acc": weighted_acc(f, truth, climatology, w).cpu().numpy(),
        "bias": weighted_bias(f, truth, w).cpu().numpy(),
    }
