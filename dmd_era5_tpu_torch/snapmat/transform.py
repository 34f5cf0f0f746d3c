"""Snapshot-matrix construction: standardize, flatten, delay-embed.

The port's counterpart of ``dmd_era5_tpu/snapmat/transform.py``:

- :func:`standardize_data`: on a ``Field``/``FieldSet``, host numpy
  along a named dim, as the JAX function; on an (S, T) tensor, per-row
  statistics along time where the tensor lies (:func:`standardize_rows`,
  which the SVD stage runs on the card);
- :func:`flatten_era5_variables`, :func:`delay_embed_np`,
  :func:`delay_embedded_coords`, :func:`apply_delay_embedding` and
  :func:`space_coord_to_level_lat_lon`, host numpy on the port's
  ``Field``/``FieldSet``, copied from the JAX package's functions.

Layout contract (load-bearing for every consumer downstream):

- flatten stacks space as (level, latitude, longitude), row-major, and
  concatenates variables along space;
- delay embedding with depth d maps (S, T) -> (S*d, T-d+1); row block
  j in [0, d) holds columns X[:, j : j+T-d+1] and carries delay index
  d-1-j; the time coordinate drops the first d-1 entries.
"""

from __future__ import annotations

import functools
import math
from itertools import product
from typing import Any

import numpy as np
import torch

from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

__all__ = [
    "SPATIAL_STACK_ORDER",
    "apply_delay_embedding",
    "delay_embed_np",
    "delay_embedded_coords",
    "flat_data",
    "flatten_era5_variables",
    "space_coord_to_level_lat_lon",
    "standardize_data",
    "standardize_rows",
]

SPATIAL_STACK_ORDER = ("level", "latitude", "longitude")


@functools.cache
def _logger():
    return setup_logger("ERA5Processing-torch", "era5_processing_torch.log")


def standardize_data(
    data: FieldSet | Field | torch.Tensor,
    dim: str = "time",
    scale: bool = True,
):
    """Mean-centre (and optionally scale to unit variance) along ``dim``.

    Returns ``(standardized, mean, std_or_None)``.  A ``Field`` or
    ``FieldSet`` is reduced along its named ``dim`` on the host, as the
    JAX function does; an (S, T) tensor row by row along time
    (:func:`standardize_rows`).
    """
    if isinstance(data, torch.Tensor):
        return standardize_rows(data, scale=scale)
    log_and_print(_logger(), f"Standardizing data along {dim} dimension...")
    mean = data.mean(dim)
    centered = data - mean
    if scale:
        std = centered.std(dim)
        return centered / std, mean, std
    return centered, mean, None


def standardize_rows(x: torch.Tensor, scale: bool = True, inplace: bool = False):
    """Mean-centre (and with ``scale`` divide by the std) each row of x.

    Returns ``(standardized, mean, std_or_None)`` with mean and std of
    shape (S,), the statistics ``models.forecast.undo_preprocessing``
    needs.  The std is the population std (ddof 0) of the centred rows.
    ``inplace`` overwrites x instead of making a centred copy.
    """
    mean = x.mean(dim=1)
    centered = x.sub_(mean[:, None]) if inplace else x - mean[:, None]
    if not scale:
        return centered, mean, None
    std = centered.std(dim=1, correction=0)
    return centered.div_(std[:, None]), mean, std


def _space_tuples(level: np.ndarray, lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """Object array of (level, lat, lon) tuples in stack order."""
    tuples = np.empty(len(level) * len(lat) * len(lon), dtype=object)
    for i, combo in enumerate(product(level, lat, lon)):
        tuples[i] = combo
    return tuples


def flatten_era5_variables(fs: FieldSet) -> Field:
    """Flatten an ERA5 FieldSet into one (space[, time]) Field.

    Space is the row-major stack of (level, latitude, longitude); when
    multiple variables are present their blocks are concatenated along
    space, first variable first.  The result carries coords ``space``
    (tuples), ``time`` (if present) and ``original_variable``.  Fields
    that hold tensors are flattened where they lie, each copied once
    into the flat tensor.
    """
    variables = fs.variables
    if not variables:
        raise ValueError("Input dataset must have at least one variable.")

    sample = fs.first()
    has_time = "time" in sample.dims
    for d in SPATIAL_STACK_ORDER:
        if d not in sample.dims:
            raise ValueError(
                "Input dataset must have coordinates "
                "('latitude', 'longitude', 'level') "
                "or ('latitude', 'longitude', 'level', 'time')."
            )

    level = np.asarray(fs.coord("level").values)
    lat = np.asarray(fs.coord("latitude").values)
    lon = np.asarray(fs.coord("longitude").values)
    space = _space_tuples(level, lat, lon)
    n_space = len(space)

    data = flat_data(fs)
    coords: dict[str, Any] = {
        "space": Coord("space", np.tile(space, len(variables))),
        "original_variable": Coord(
            "space", np.repeat(np.asarray(variables, dtype=object), n_space)
        ),
    }
    dims = ("space", "time") if has_time else ("space",)
    if has_time:
        coords["time"] = Coord("time", fs.coord("time").values)

    attrs = dict(fs.attrs)
    attrs["original_variables"] = list(variables)
    attrs["space_coords"] = list(SPATIAL_STACK_ORDER)
    return Field(data, dims, coords, attrs, name="X")


def flat_data(fs: FieldSet):
    """The data of :func:`flatten_era5_variables` alone, without its
    coordinates: (space[, time]), the variables' blocks stacked in order,
    each (level, latitude, longitude) row-major.  Tensor fields are
    flattened where they lie, each copied once into the flat tensor."""
    variables = fs.variables
    sample = fs.first()
    has_time = "time" in sample.dims
    shape = tuple(sample.sizes[d] for d in SPATIAL_STACK_ORDER)
    n_space = math.prod(shape)
    order = (*SPATIAL_STACK_ORDER, "time") if has_time else SPATIAL_STACK_ORDER
    if isinstance(sample.data, torch.Tensor):
        tail = (sample.sizes["time"],) if has_time else ()
        data = torch.empty((len(variables) * n_space, *tail), dtype=sample.data.dtype,
                           device=sample.data.device)
        for i, var in enumerate(variables):
            field = fs[var]
            block = data[i * n_space : (i + 1) * n_space]
            block.view(*shape, *tail).copy_(field.data.permute([field.axis(d) for d in order]))
        return data
    blocks = []
    for var in variables:
        arr = fs[var].transpose(*order).data
        blocks.append(arr.reshape(n_space, arr.shape[-1]) if has_time else arr.reshape(n_space))
    return np.concatenate([np.asarray(b) for b in blocks], axis=0)


def delay_embed_np(X: np.ndarray, d: int) -> np.ndarray:
    """Delay-embed a (S, T) snapshot matrix to (S*d, T-d+1): row block j
    holds the time-shifted view ``X[:, j : j+T-d+1]``; block 0 is the
    most-delayed."""
    if X.ndim != 2:
        raise ValueError("Input array must be 2D.")
    if not isinstance(d, int) or isinstance(d, bool) or d <= 0:
        raise ValueError("Delay must be an integer greater than 0.")
    t_out = X.shape[1] - d + 1
    if t_out < 1:
        raise ValueError("Delay embedding longer than the time series.")
    return np.concatenate([X[:, j : j + t_out] for j in range(d)], axis=0)


def delay_embedded_coords(X: Field, d: int) -> dict[str, Coord]:
    """Coordinates of the delay-embedded matrix WITHOUT building it:
    space/original_variable tiled d times, the per-row delay coord, time
    dropping the first d-1 entries -- the coords
    :func:`apply_delay_embedding` attaches."""
    n_space = X.sizes["space"]
    return {
        "space": Coord("space", np.tile(X.coords["space"].values, d)),
        "time": Coord("time", X.coords["time"].values[d - 1 :]),
        "original_variable": Coord(
            "space", np.tile(X.coords["original_variable"].values, d)
        ),
        "delay": Coord("space", np.repeat(np.flip(np.arange(d)), n_space)),
    }


def apply_delay_embedding(X: Field, d: int) -> Field:
    """Delay-embed a (space, time) Field on the host, propagating
    coordinates: space and original_variable tiled d times, a per-row
    ``delay`` coord equal to ``repeat([d-1, ..., 0], n_space)``, and the
    time coord dropping its first d-1 entries."""
    if not isinstance(X, Field):
        raise ValueError("Input data must be a Field")
    if sorted(X.dims) != ["space", "time"]:
        raise ValueError("Input data must have dimensions ('space', 'time').")
    needed = {"space", "time", "original_variable"}
    if set(X.coords) < needed:
        raise ValueError(
            "Input data must have coordinates "
            "('space', 'time', 'original_variable')."
        )

    data = delay_embed_np(np.asarray(X.transpose("space", "time").data), d)
    coords = delay_embedded_coords(X, d)
    attrs = dict(X.attrs)
    attrs["delay_embedding"] = d
    return Field(data, ("space", "time"), coords, attrs, name=X.name)


def space_coord_to_level_lat_lon(fs: FieldSet) -> FieldSet:
    """Split the tuple-valued space coord into level/lat/lon coords.

    HDF5 cannot store tuple-valued coordinate arrays, so before
    serialization the space coord becomes a 0..S-1 integer index with
    three parallel coords.  A FieldSet already split is returned as is.
    """
    space = None
    for field in fs.data_vars.values():
        if "space" in field.coords:
            space = field.coords["space"]
            break
    if space is None:
        raise ValueError("Input dataset must have a 'space' coordinate.")

    try:
        for name in ("level", "latitude", "longitude"):
            fs.coord(name)
    except KeyError:
        pass
    else:
        log_and_print(
            _logger(),
            "Dataset already has separate coordinates for "
            "level, latitude, and longitude.",
        )
        return fs

    tuples = space.values
    level = np.asarray([t[0] for t in tuples])
    lat = np.asarray([t[1] for t in tuples])
    lon = np.asarray([t[2] for t in tuples])
    index = np.arange(len(tuples), dtype=int)

    def convert(field: Field) -> Field:
        if "space" not in field.coords:
            return field
        new_coords = dict(field.coords)
        new_coords["space"] = Coord("space", index)
        new_coords["level"] = Coord("space", level)
        new_coords["latitude"] = Coord("space", lat)
        new_coords["longitude"] = Coord("space", lon)
        return Field(field.data, field.dims, new_coords, field.attrs, field.name)

    return fs.map(convert)
