"""HDF5 serialization of FieldSets, netCDF4-compatible on disk.

The port's counterpart of ``dmd_era5_tpu/utils/io_h5.py``, with the same
on-disk layout and the same write order and dataset flags, so that a
file written by either package loads in the other, and one FieldSet
written by both gives the same bytes:

- data variables and coordinate variables are ROOT-group datasets;
- every dimension is an HDF5 dimension scale attached to each
  variable's axis (``CLASS = "DIMENSION_SCALE"`` + ``DIMENSION_LIST``);
- dimensions without a coordinate get the netCDF hidden-scale marker
  (``NAME = "This is a netCDF dimension but not a netCDF variable."``);
- auxiliary coordinates (e.g. ``original_variable`` over ``space``) are
  listed in the CF ``coordinates`` attribute of each data variable;
- times are int64 with CF units ``nanoseconds since 1970-01-01`` and
  load back as ``datetime64[ns]``, whatever unit they were written in.

``load_fieldset`` also reads the legacy grouped layout (``/vars`` +
``/coords``) and returns numpy arrays.  A data variable that holds a
tensor (on the card or the host) is written in slabs along its first
axis, so no host copy of the whole array is made.  The files are read
and written by the port's own HDF5 codec (``utils/hdf5.py``), with no
HDF5 library: they hold what the JAX writer's hold, name for name and
value for value, though not at the same offsets.

Tuple-valued coordinates are not serializable: callers run
``space_coord_to_level_lat_lon`` first.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from dmd_era5_tpu_torch.utils import hdf5
from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

__all__ = ["load_fieldset", "save_fieldset"]

_TIME_UNIT = "nanoseconds since 1970-01-01"
# the exact marker netCDF4-c puts on coordinate-less dimension scales
_NC_HIDDEN_DIM = "This is a netCDF dimension but not a netCDF variable."
# HDF5/netCDF machinery attributes that are not Field attrs
_RESERVED_ATTRS = {
    "dims",
    "coordinates",
    "CLASS",
    "NAME",
    "REFERENCE_LIST",
    "DIMENSION_LIST",
    "_Netcdf4Dimid",
    "_Netcdf4Coordinates",
    "_NCProperties",
}
# the most bytes of a tensor's slab copied to the host at a time
_SLAB_BYTES = 1 << 28


def _encode_attr(value: Any):
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, str) for v in value):
            return _str_list_attr(value)
        return np.asarray(value)
    if isinstance(value, bool):
        return int(value)
    if value is None:
        return "__none__"
    if isinstance(value, dict):
        return "__json__" + json.dumps(value)
    return value


def _decode_attr(value: Any):
    if isinstance(value, str):
        if value == "__none__":
            return None
        if value.startswith("__json__"):
            return json.loads(value[len("__json__") :])
        return value
    if isinstance(value, np.ndarray):
        return value.tolist() if value.dtype.kind == "O" else value
    if isinstance(value, np.generic):
        return value.item()
    return value


def _encode_array(values: np.ndarray) -> tuple[np.ndarray, dict]:
    meta: dict[str, Any] = {}
    if values.dtype.kind == "M":  # datetime64
        meta["units"] = _TIME_UNIT
        return values.astype("datetime64[ns]").astype(np.int64), meta
    if values.dtype.kind == "O" and all(issubclass(k, str) for k in set(map(type, values.flat))):
        return values, meta
    if values.dtype.kind in ("U", "O"):
        return _str_list_attr(values.ravel()).reshape(values.shape), meta
    return values, meta


def _decode_array(ds) -> np.ndarray:
    values = ds[()]
    if ds.attrs.get("units") == _TIME_UNIT:
        return values.astype("datetime64[ns]")
    return values


def _str_list_attr(values) -> np.ndarray:
    out = np.empty(len(values), object)
    out[:] = [str(v) for v in values]
    return out


def _write_tensor(f, name: str, t: torch.Tensor):
    """A dataset of t's shape and dtype, filled slab by slab along its
    first axis from t's device."""
    dtype = torch.empty((), dtype=t.dtype).numpy().dtype
    ds = f.create_dataset(name, shape=tuple(t.shape), dtype=dtype)
    row_bytes = max(1, t[:1].numel() * t.element_size())
    rows = max(1, _SLAB_BYTES // row_bytes)
    for r0 in range(0, t.shape[0], rows):
        r1 = min(r0 + rows, t.shape[0])
        ds[r0:r1] = t[r0:r1].contiguous().cpu().numpy()
    return ds


def save_fieldset(fs: FieldSet, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with hdf5.File(path, "w") as f:
        for key, value in fs.attrs.items():
            f.attrs[key] = _encode_attr(value)

        # ---- collect coords (consistency-checked) and dim sizes ----
        coords: dict[str, Coord] = {}
        for field in fs.data_vars.values():
            for cname, coord in field.coords.items():
                if cname in coords:
                    if not (coords[cname] == coord):
                        raise ValueError(f"Inconsistent coord {cname!r} across fields")
                else:
                    coords[cname] = coord
        dim_sizes: dict[str, int] = {}
        for field in fs.data_vars.values():
            for d, n in zip(field.dims, field.shape):
                dim_sizes[d] = n
        for coord in coords.values():
            for d, n in zip(coord.dims, coord.values.shape):
                dim_sizes.setdefault(d, n)

        def write_dataset(name: str, values, dims):
            if isinstance(values, torch.Tensor):
                ds, meta = _write_tensor(f, name, values), {}
            else:
                arr, meta = _encode_array(np.asarray(values))
                ds = f.create_dataset(name, data=arr)
            ds.attrs["dims"] = _str_list_attr(dims)
            for k, v in meta.items():
                ds.attrs[k] = v
            return ds

        # ---- dimension scales: coord vars where dims == (name,) ----
        for cname, coord in coords.items():
            if tuple(coord.dims) == (cname,):
                ds = write_dataset(cname, coord.values, coord.dims)
                ds.make_scale(cname)
        # hidden scales for dimensions without a coordinate variable
        for d, n in dim_sizes.items():
            if d not in f:
                ds = f.create_dataset(d, shape=(n,), dtype="f4")
                ds.make_scale(d)
                # overwrite NAME with the netCDF hidden-dimension marker
                del ds.attrs["NAME"]
                ds.attrs["NAME"] = np.bytes_((_NC_HIDDEN_DIM + "%10d") % n)

        def attach(ds, dims) -> None:
            for i, d in enumerate(dims):
                ds.attach_scale(i, f[d])

        # ---- auxiliary coordinates (dims != (name,)) ----
        aux_names: list[str] = []
        for cname, coord in coords.items():
            if tuple(coord.dims) != (cname,):
                ds = write_dataset(cname, coord.values, coord.dims)
                attach(ds, coord.dims)
                aux_names.append(cname)

        # ---- data variables ----
        for name, field in fs.data_vars.items():
            if name in f:
                raise ValueError(f"Data variable {name!r} collides with a coordinate")
            ds = write_dataset(name, field.data, field.dims)
            attach(ds, field.dims)
            aux_here = [c for c in field.coords if c in aux_names]
            if aux_here:
                ds.attrs["coordinates"] = " ".join(aux_here)
            for k, v in field.attrs.items():
                ds.attrs[k] = _encode_attr(v)


def _dims_attr(ds) -> tuple[str, ...]:
    return tuple(ds.attrs["dims"])


def _load_legacy(f) -> FieldSet:
    """The pre-netCDF grouped layout (/vars + /coords)."""
    attrs = {k: _decode_attr(v) for k, v in f.attrs.items()}
    coords: dict[str, Coord] = {}
    for cname, cds in f["coords"].items():
        coords[cname] = Coord(_dims_attr(cds), _decode_array(cds))
    data_vars: dict[str, Field] = {}
    for name, ds in f["vars"].items():
        dims = _dims_attr(ds)
        field_attrs = {
            k[len("attr_") :]: _decode_attr(v)
            for k, v in ds.attrs.items()
            if k.startswith("attr_")
        }
        field_coords = {
            cname: coord
            for cname, coord in coords.items()
            if all(d in dims for d in coord.dims)
        }
        data_vars[name] = Field(_decode_array(ds), dims, field_coords, field_attrs, name)
    return FieldSet(data_vars, attrs=attrs)


def _is_hidden_scale(ds) -> bool:
    name = ds.attrs.get("NAME")
    return isinstance(name, str) and name.startswith(_NC_HIDDEN_DIM)


def _dims_of(ds, fallback: str) -> tuple[str, ...]:
    if "dims" in ds.attrs:
        return _dims_attr(ds)
    # pure netCDF files (no "dims" attr): recover from attached scales
    return tuple(names[0].lstrip("/") if names else f"{fallback}_{i}"
                 for i, names in enumerate(ds.scales()))


def load_fieldset(path: str | Path) -> FieldSet:
    with hdf5.File(path, "r") as f:
        if "vars" in f and isinstance(f["vars"], hdf5.Group):
            return _load_legacy(f)

        attrs = {
            k: _decode_attr(v)
            for k, v in f.attrs.items()
            if k not in _RESERVED_ATTRS
        }
        datasets = {name: obj for name, obj in f.items() if isinstance(obj, hdf5.Dataset)}
        # classification: dimension scales -> dim coords; names listed
        # in any CF "coordinates" attr -> aux coords; the rest -> data
        coord_names: set[str] = set()
        for name, ds in datasets.items():
            if ds.attrs.get("CLASS") == "DIMENSION_SCALE" and not _is_hidden_scale(ds):
                coord_names.add(name)
        for ds in datasets.values():
            listed = ds.attrs.get("coordinates")
            if listed is not None:
                coord_names.update(str(listed).split())

        coords: dict[str, Coord] = {}
        for cname in sorted(coord_names):
            ds = datasets[cname]
            coords[cname] = Coord(_dims_of(ds, cname), _decode_array(ds))

        data_vars: dict[str, Field] = {}
        for name, ds in datasets.items():
            if name in coord_names or _is_hidden_scale(ds):
                continue
            dims = _dims_of(ds, name)
            field_attrs = {
                k: _decode_attr(v)
                for k, v in ds.attrs.items()
                if k not in _RESERVED_ATTRS
                and not (k == "units" and _decode_attr(v) == _TIME_UNIT)
            }
            field_coords = {
                cname: coord
                for cname, coord in coords.items()
                if all(d in dims for d in coord.dims)
            }
            data_vars[name] = Field(_decode_array(ds), dims, field_coords, field_attrs, name)
    return FieldSet(data_vars, attrs=attrs)
