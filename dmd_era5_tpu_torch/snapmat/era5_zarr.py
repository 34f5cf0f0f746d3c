"""ERA5 ingest from a Zarr v2 store (a local directory or a gs:// URL).

The port's counterpart of ``dmd_era5_tpu/snapmat/era5_zarr.py``, with
explicit **slice pushdown**: the requested time range and pressure
levels become index ranges against the (small, eagerly read) coordinate
arrays, and only the covering chunks of each requested variable are
fetched and decoded.  Two consumers:

- :func:`read_era5_zarr_slice` materializes the slice as a FieldSet of
  host numpy fields for the ingest stage;
- :func:`zarr_to_packed` streams time blocks through
  ``native.pack_space_time`` into the packed snapshot artifact
  (``snapmat/loader.py``) without holding the slice in host memory, for
  the streamed (out-of-core) SVD backends.
"""

from __future__ import annotations

import functools
from datetime import datetime
from pathlib import Path

import numpy as np

from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.native import pack_space_time
from dmd_era5_tpu_torch.snapmat.loader import SnapshotMeta, write_meta
from dmd_era5_tpu_torch.snapmat.zarr_reader import ZarrGroup, decode_cf_time, open_zarr_group
from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

__all__ = ["read_era5_zarr_slice", "zarr_to_packed", "open_era5_zarr"]

_DIMS = ("time", "level", "latitude", "longitude")
# time-major hours gathered by zarr_to_packed before one packed write
PACK_BUFFER_BYTES = 1 << 28


@functools.cache
def _logger():
    return setup_logger("ERA5Zarr-torch", "era5_zarr_torch.log")


def open_era5_zarr(source: str | Path) -> ZarrGroup:
    return open_zarr_group(source)


def _read_time_coord(group: ZarrGroup) -> np.ndarray:
    arr = group["time"]
    values = arr[:]
    units = arr.attrs.get("units")
    if values.dtype.kind == "M":
        return values.astype("datetime64[ns]")
    if units is None:
        raise ValueError(
            "Zarr time coordinate has no CF 'units' attribute and is not datetime-typed."
        )
    return decode_cf_time(values, units)


def _index_bounds(times: np.ndarray, start: datetime, end: datetime) -> tuple[int, int]:
    """[t0, t1) index range covering the inclusive [start, end] window."""
    t64 = times.astype("datetime64[ns]")
    s64 = np.datetime64(start, "ns")
    e64 = np.datetime64(end, "ns")
    if s64 < t64[0] or e64 > t64[-1]:
        raise ValueError(
            f"Time range ({start} to {end}) is outside dataset bounds "
            f"({t64[0]} to {t64[-1]})."
        )
    t0 = int(np.searchsorted(t64, s64, side="left"))
    t1 = int(np.searchsorted(t64, e64, side="right"))
    if t1 <= t0:
        raise ValueError(f"Empty time selection for {start}..{end}")
    return t0, t1


def _level_indices(level_values: np.ndarray, levels: list[int]) -> np.ndarray:
    idx = []
    for lev in levels:
        hits = np.nonzero(level_values == lev)[0]
        if hits.size == 0:
            raise ValueError(
                "Requested level is not available in the dataset. "
                f"Available levels: {[int(v) for v in level_values]}"
            )
        idx.append(int(hits[0]))
    return np.asarray(idx)


def _var_axis_order(arr) -> list[int]:
    """Map the on-store dim order to the canonical (_DIMS) order."""
    dims = arr.dims
    if dims is None:
        if arr.ndim != 4:
            raise ValueError(
                f"Variable {arr.path!r} has no _ARRAY_DIMENSIONS and is "
                f"{arr.ndim}-D; cannot infer layout."
            )
        return list(range(4))
    if sorted(dims) != sorted(_DIMS):
        raise ValueError(f"Variable {arr.path!r} has dims {dims}, expected {_DIMS}")
    return [dims.index(d) for d in _DIMS]


def _selection(group: ZarrGroup, start: datetime, end: datetime, levels: list[int] | None):
    """(times, level values, lats, lons, t0, t1, level indices) of a window."""
    times = _read_time_coord(group)
    level_values = np.asarray(group["level"][:])
    lats = np.asarray(group["latitude"][:])
    lons = np.asarray(group["longitude"][:])
    t0, t1 = _index_bounds(times, start, end)
    levels = levels or [int(v) for v in level_values]
    return times, level_values, lats, lons, t0, t1, _level_indices(level_values, levels)


def _read_block(arr, order: list[int], b0: int, b1: int, lev_idx: np.ndarray) -> np.ndarray:
    """Hours [b0, b1) of the chosen levels in canonical order, float32."""
    sel: list = [slice(None)] * 4
    sel[order[0]] = slice(b0, b1)
    sel[order[1]] = lev_idx
    block = np.transpose(arr[tuple(sel)], order)  # store order -> canonical
    return np.ascontiguousarray(block.astype(np.float32))


def read_era5_zarr_slice(
    source: str | Path,
    variables: list[str],
    start_datetime: datetime,
    end_datetime: datetime,
    levels: list[int] | None = None,
) -> FieldSet:
    """Materialize an ERA5 slice from a Zarr store as a FieldSet.

    Only the chunks covering [start, end] x levels are read.  The result
    has the mock backend's (time, level, latitude, longitude) layout, so
    the slicing, resampling and flattening that follow do not depend on
    the source.
    """
    group = open_era5_zarr(source)
    available = group.array_keys()
    for var in variables:
        if var not in available:
            raise ValueError(f"Variable {var!r} not present in Zarr store (has: {available})")

    times, level_values, lats, lons, t0, t1, lev_idx = _selection(
        group, start_datetime, end_datetime, levels
    )
    coords = {
        "time": Coord("time", times[t0:t1]),
        "level": Coord("level", level_values[lev_idx].astype(int)),
        "latitude": Coord("latitude", lats),
        "longitude": Coord("longitude", lons),
    }
    data_vars: dict[str, Field] = {}
    for var in variables:
        arr = group[var]
        data_vars[var] = Field(
            _read_block(arr, _var_axis_order(arr), t0, t1, lev_idx),
            dims=_DIMS,
            coords=coords,
            attrs={k: v for k, v in arr.attrs.items() if k != "_ARRAY_DIMENSIONS"},
            name=var,
        )
    log_and_print(
        _logger(),
        f"Read ERA5 Zarr slice: {len(variables)} var(s), "
        f"times[{t0}:{t1}], {len(lev_idx)} level(s) from {source}",
    )
    return FieldSet(data_vars, attrs=dict(group.attrs))


def zarr_to_packed(
    source: str | Path,
    out_path: str | Path,
    variables: list[str],
    start_datetime: datetime,
    end_datetime: datetime,
    levels: list[int] | None = None,
    bf16: bool = False,
    row_chunk: int = 4096,
) -> tuple[int, int]:
    """Stream a Zarr ERA5 slice into a packed (space, time) artifact.

    For each variable, the hours of each chunk-aligned time block are
    read and gathered time-major into a host buffer of at most
    ``PACK_BUFFER_BYTES`` (256 MiB; at least one block), which
    ``native.pack_space_time`` turns space-major (bf16 words with
    ``bf16=True``) and one write stores as a column slab.  Host memory
    thus stays at about one buffer whatever the slice's length, and a
    store chunked by the hour (ARCO-ERA5's) does not write the artifact
    one strided column at a time.  The matrix equals
    ``build_snapshot_matrix`` of ``read_era5_zarr_slice``'s FieldSet.

    A ``.npy`` ``out_path`` is written through ``np.lib.format.
    open_memmap`` and holds X alone; any other path is HDF5 as the JAX
    package writes it (dataset ``X`` in ``(row_chunk, 512)`` chunks, the
    ``bf16`` attribute, and the coordinates).  Returns (n_rows, n_cols)
    of the packed matrix.
    """
    group = open_era5_zarr(source)
    times, level_values, lats, lons, t0, t1, lev_idx = _selection(
        group, start_datetime, end_datetime, levels
    )
    n_space_var = len(lev_idx) * len(lats) * len(lons)
    n_rows = n_space_var * len(variables)
    n_cols = t1 - t0
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    dtype = np.uint16 if bf16 else np.float32
    meta = SnapshotMeta(list(variables), level_values[lev_idx].astype(int), lats, lons,
                        times[t0:t1])

    def write_all(dest) -> None:
        per_flush = max(1, PACK_BUFFER_BYTES // (4 * n_space_var))
        for vi, var in enumerate(variables):
            arr = group[var]
            order = _var_axis_order(arr)
            r0 = vi * n_space_var
            buf = np.empty((min(per_flush, n_cols), n_space_var), dtype=np.float32)
            c0 = filled = 0  # slab start column, hours in the buffer

            def flush() -> None:
                dest[r0 : r0 + n_space_var, c0 : c0 + filled] = pack_space_time(
                    buf[:filled], bf16=bf16
                )

            for b0, b1 in arr.iter_axis_blocks(order[0], t0, t1):
                block = _read_block(arr, order, b0, b1, lev_idx).reshape(b1 - b0, -1)
                if filled and filled + len(block) > len(buf):
                    flush()
                    c0, filled = c0 + filled, 0
                if len(block) > len(buf):  # a time chunk wider than the buffer
                    buf = np.empty((len(block), n_space_var), dtype=np.float32)
                buf[filled : filled + len(block)] = block
                filled += len(block)
            if filled:
                flush()

    if out_path.suffix == ".npy":
        dest = np.lib.format.open_memmap(out_path, mode="w+", dtype=dtype, shape=(n_rows, n_cols))
        try:
            write_all(dest)
            dest.flush()
        finally:
            del dest
    else:
        import h5py

        with h5py.File(out_path, "w") as f:
            dset = f.create_dataset(
                "X", shape=(n_rows, n_cols), dtype=dtype,
                chunks=(min(row_chunk, n_rows), min(n_cols, 512)),
            )
            f.attrs["bf16"] = int(bf16)
            write_meta(f, meta)
            write_all(dset)
    log_and_print(
        _logger(),
        f"Packed ERA5 Zarr slice to {out_path}: {n_rows} x {n_cols} "
        f"({'bf16' if bf16 else 'f32'})",
    )
    return n_rows, n_cols
