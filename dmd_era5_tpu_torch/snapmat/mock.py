"""Synthetic ERA5-like data: the test oracle backbone.

The port's counterpart of ``dmd_era5_tpu/snapmat/mock.py``: a 5-degree
global grid (36 lat x 72 lon) with hourly snapshots and per-variable
synthetic structure, plus :func:`create_mock_era5_svd`, which runs the
host preprocessing chain and an exact truncated SVD.  Times come from
numpy (no pandas); the draws are numpy's on the host, the same calls in
the same order as the JAX package's, so one seed (or one state of the
global ``np.random``) gives both packages the same data bit for bit.
"""

from __future__ import annotations

import functools
from datetime import datetime

import numpy as np

from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.snapmat.transform import (
    apply_delay_embedding,
    flatten_era5_variables,
    standardize_data,
)
from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

__all__ = ["create_mock_era5", "create_mock_era5_svd"]

_LAT_STEP = 5.0
_LON_STEP = 5.0
_HOUR_NS = 3_600_000_000_000


@functools.cache
def _logger():
    return setup_logger("MockData-torch", "mock_data_torch.log")


def _hourly_times(start_datetime: datetime | str, end_datetime: datetime | str) -> np.ndarray:
    """Hourly ``datetime64[ns]`` stamps from start to end, both inclusive."""
    t0 = np.datetime64(start_datetime, "ns")
    t1 = np.datetime64(end_datetime, "ns")
    n = int((t1 - t0).astype(np.int64) // _HOUR_NS) + 1
    return t0 + np.arange(max(n, 0), dtype=np.int64) * np.timedelta64(_HOUR_NS, "ns")


def _synthesize_variable(
    var_name: str,
    n_time: int,
    levels: list[int],
    lats: np.ndarray,
    lons: np.ndarray,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Synthetic physics per variable: temperature = U(0,1)*30+250 with a
    -(1000-level)/100 lapse and cos(latitude) modulation; wind =
    U(0,1)*20-10; anything else = U(0,1)*100.  Draws from ``rng`` when
    given, else from the global ``np.random`` state."""
    shape = (n_time, len(levels), len(lats), len(lons))
    draw = np.random.rand(*shape) if rng is None else rng.random(shape)

    if var_name == "temperature":
        data = draw * 30 + 250
        lapse = (1000.0 - np.asarray(levels, dtype=float)) / 100.0
        data = data - lapse[None, :, None, None]
        lat_factor = np.cos(np.radians(lats))
        data = data * lat_factor[None, None, :, None]
    elif "wind" in var_name:
        data = draw * 20 - 10
    else:
        data = draw * 100
    return data


def create_mock_era5(
    start_datetime: datetime | str,
    end_datetime: datetime | str,
    variables: list[str],
    levels: list[int],
    seed: int | None = None,
) -> FieldSet:
    """Create a mock ERA5-like FieldSet on a 5-degree grid, hourly.

    Latitude 90 -> -85 in steps of -5 (36 points), longitude -180 -> 175
    in steps of 5 (72 points).  ``seed`` gives deterministic data.
    """
    times = _hourly_times(start_datetime, end_datetime)
    lats = np.arange(90, -90, -_LAT_STEP)
    lons = np.arange(-180, 180, _LON_STEP)
    rng = np.random.default_rng(seed) if seed is not None else None

    data_vars = {}
    for var in variables:
        data = _synthesize_variable(var, len(times), levels, lats, lons, rng)
        units = "K" if var == "temperature" else "m/s" if "wind" in var else "unknown"
        data_vars[var] = Field(
            data,
            dims=("time", "level", "latitude", "longitude"),
            coords={
                "time": Coord("time", times),
                "level": Coord("level", np.asarray(levels)),
                "latitude": Coord("latitude", lats),
                "longitude": Coord("longitude", lons),
            },
            attrs={"units": units},
            name=var,
        )

    log_and_print(_logger(), "Mock ERA5 dataset creation completed successfully")
    return FieldSet(
        data_vars,
        attrs={
            "Conventions": "CF-1.6",
            "history": "Mock ERA5 data created for testing",
            "source": "Generated mock data",
        },
    )


def create_mock_era5_svd(
    start_datetime: datetime | str = "2020-01-01",
    end_datetime: datetime | str = "2020-01-02",
    variables: list[str] | None = None,
    levels: list[int] | None = None,
    mean_center: bool = True,
    scale: bool = False,
    delay_embedding: int = 2,
    n_components: int = 6,
    seed: int | None = None,
):
    """Mock SVD results via the exact host pipeline (the test oracle).

    Runs standardize -> flatten -> delay-embed -> exact truncated SVD
    (``np.linalg.svd``) and returns ``(U, s, V, coords, X)`` where
    ``coords`` are the coordinates of the preprocessed snapshot matrix.
    """
    variables = variables or ["temperature"]
    levels = levels or [1000]

    fs = create_mock_era5(start_datetime, end_datetime, variables, levels, seed=seed)
    if mean_center:
        fs, _, _ = standardize_data(fs, scale=scale)
    da = flatten_era5_variables(fs)
    da = apply_delay_embedding(da, delay_embedding)

    U, s, V = np.linalg.svd(np.asarray(da.data), full_matrices=False)
    return U[:, :n_components], s[:n_components], V[:n_components, :], da.coords, da
