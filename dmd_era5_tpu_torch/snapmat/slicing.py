"""Time/level slicing and resampling of ERA5-like FieldSets.

The port's counterpart of ``dmd_era5_tpu/snapmat/slicing.py``:
:func:`slice_era5_dataset` selects a time range (end inclusive) and
pressure levels with bounds validation, :func:`resample_era5_dataset`
resamples time to the nearest snapshot at a fixed stride.  Times are
numpy ``datetime64[ns]`` arithmetic (no pandas).  A selection that is an
evenly spaced run of indices is taken as a slice, so a Field's data
(a host array or a tensor on the card) comes back as a view, not a
copy; the values are those the JAX functions select.
"""

from __future__ import annotations

import functools
from datetime import datetime, timedelta

import numpy as np

from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.utils.labels import FieldSet

__all__ = ["dataset_time_bounds", "resample_era5_dataset", "slice_era5_dataset"]


@functools.cache
def _logger():
    return setup_logger("ERA5Processing-torch", "era5_processing_torch.log")


def _to_datetime(value: datetime | str | None) -> datetime | None:
    if isinstance(value, str):
        return datetime.fromisoformat(value)
    return value


def _times_of(fs: FieldSet) -> np.ndarray:
    return np.asarray(fs.coord("time").values).astype("datetime64[ns]")


def _as_python_datetime(t: np.datetime64) -> datetime:
    # microseconds are python's resolution, as pd.Timestamp.to_pydatetime
    return t.astype("datetime64[us]").item()


def _selection(idx: np.ndarray):
    """An evenly spaced increasing run of indices as a slice, else the
    indices: the same elements, a view where the data allows one."""
    idx = np.asarray(idx)
    if idx.size == 0:
        return idx
    step = int(idx[1] - idx[0]) if idx.size > 1 else 1
    if step > 0 and np.array_equal(idx, idx[0] + step * np.arange(idx.size)):
        return slice(int(idx[0]), int(idx[-1]) + 1, step)
    return idx


def dataset_time_bounds(fs: FieldSet) -> tuple[datetime, datetime]:
    """First/last timestamps of the FieldSet as python datetimes."""
    times = _times_of(fs)
    return _as_python_datetime(times[0]), _as_python_datetime(times[-1])


def slice_era5_dataset(
    fs: FieldSet,
    start_datetime: datetime | str | None = None,
    end_datetime: datetime | str | None = None,
    levels: list[int] | None = None,
) -> FieldSet:
    """Select a time range (inclusive) and a set of pressure levels.

    Raises ValueError if the requested range is outside the data bounds,
    if start >= end, or if a requested level is absent.
    """
    start_dt = _to_datetime(start_datetime)
    end_dt = _to_datetime(end_datetime)
    first, last = dataset_time_bounds(fs)
    start_dt = start_dt or first
    end_dt = end_dt or last

    if start_dt < first or end_dt > last:
        msg = (
            f"Time range ({start_dt} to {end_dt}) is outside dataset "
            f"bounds ({first} to {last})."
        )
        log_and_print(_logger(), msg, "error")
        raise ValueError(msg)
    if start_dt >= end_dt:
        msg = "Start datetime must be before end datetime."
        log_and_print(_logger(), msg, "error")
        raise ValueError(msg)

    times = _times_of(fs)
    t64_start = np.datetime64(start_dt, "ns")
    t64_end = np.datetime64(end_dt, "ns")
    time_idx = np.nonzero((times >= t64_start) & (times <= t64_end))[0]
    out = fs.isel(time=_selection(time_idx))

    level_values = np.asarray(fs.coord("level").values)
    if levels is None:
        levels = [int(v) for v in level_values]
    level_idx = []
    for lev in levels:
        hits = np.nonzero(level_values == lev)[0]
        if hits.size == 0:
            msg = (
                "Requested level is not available in the dataset. "
                f"Available levels: {[int(v) for v in level_values]}"
            )
            log_and_print(_logger(), msg, "error")
            raise ValueError(msg)
        level_idx.append(int(hits[0]))
    out = out.isel(level=_selection(np.asarray(level_idx)))

    log_and_print(
        _logger(),
        f"Dataset slicing completed successfully using {start_dt} "
        f"to {end_dt} and levels {levels}",
    )
    return out


def resample_era5_dataset(fs: FieldSet, delta_time: timedelta) -> FieldSet:
    """Nearest-neighbor resampling along time at a fixed stride.

    Target timestamps are laid out from the first sample at
    ``delta_time`` intervals up to the last (inclusive, as
    ``pd.date_range``) and each is mapped to the nearest source
    snapshot, ties to the earlier one.
    """
    src = _times_of(fs).astype(np.int64)
    step = int(np.timedelta64(delta_time, "ns").astype(np.int64))
    tgt = src[0] + step * np.arange((src[-1] - src[0]) // step + 1, dtype=np.int64)
    pos = np.searchsorted(src, tgt)
    pos = np.clip(pos, 0, len(src) - 1)
    left = np.clip(pos - 1, 0, len(src) - 1)
    choose_left = np.abs(tgt - src[left]) <= np.abs(src[pos] - tgt)
    idx = np.where(choose_left, left, pos)

    out = fs.isel(time=_selection(idx))
    log_and_print(_logger(), f"Resampled the dataset with time delta: {delta_time}")
    return out
