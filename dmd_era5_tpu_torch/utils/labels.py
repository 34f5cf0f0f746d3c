"""Minimal named-dimension array containers.

The port's copy of ``dmd_era5_tpu/utils/labels.py``: the small slice of
labeled-array semantics the pipeline needs, in place of xarray:

- :class:`Field`    ~ xr.DataArray: one array + named dims + coords + attrs
- :class:`FieldSet` ~ xr.Dataset:   named Fields sharing coords + attrs

Bookkeeping (coords, attrs, selection) stays on host in numpy; the dense
payload of a Field may be a numpy array *or* any array with ``.ndim``,
such as a tensor on the card, which the Field holds where it lies (the
SVD stage's dispatcher reads it from ``.data``).  ``values``,
``transpose`` and the mean/std reductions are numpy's.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np

__all__ = ["Coord", "Field", "FieldSet"]


class Coord:
    """A coordinate: values (+ the dims they are laid out along)."""

    __slots__ = ("dims", "values")

    def __init__(self, dims: tuple[str, ...] | str, values: Any):
        if isinstance(dims, str):
            dims = (dims,)
        self.dims = tuple(dims)
        self.values = np.asarray(values)

    def __len__(self) -> int:
        return len(self.values)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Coord)
            and self.dims == other.dims
            and self.values.shape == other.values.shape
            and bool(np.all(self.values == other.values))
        )

    def __repr__(self) -> str:
        return f"Coord(dims={self.dims}, n={self.values.shape})"


def _as_coord(dim_hint: str, value: Any) -> Coord:
    if isinstance(value, Coord):
        return value
    if (
        isinstance(value, tuple)
        and len(value) == 2
        and isinstance(value[0], (str, tuple, list))
    ):
        return Coord(value[0] if not isinstance(value[0], list) else tuple(value[0]),
                     value[1])
    return Coord(dim_hint, value)


class Field:
    """A single named-dims array with coordinates and attributes."""

    def __init__(
        self,
        data: Any,
        dims: Iterable[str],
        coords: Mapping[str, Any] | None = None,
        attrs: Mapping[str, Any] | None = None,
        name: str | None = None,
    ):
        self.data = data if hasattr(data, "ndim") else np.asarray(data)
        self.dims = tuple(dims)
        if self.data.ndim != len(self.dims):
            raise ValueError(
                f"Field data has {self.data.ndim} dims but names {self.dims}"
            )
        self.coords: dict[str, Coord] = {}
        for cname, cval in (coords or {}).items():
            coord = _as_coord(cname, cval)
            for d in coord.dims:
                if d not in self.dims:
                    raise ValueError(f"Coord {cname} refers to unknown dim {d}")
            expected = tuple(self.sizes[d] for d in coord.dims)
            if coord.values.shape != expected:
                raise ValueError(
                    f"Coord {cname} has shape {coord.values.shape}, "
                    f"expected {expected}"
                )
            self.coords[cname] = coord
        self.attrs: dict[str, Any] = dict(attrs or {})
        self.name = name

    # -- basic properties ---------------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.dims, self.data.shape))

    @property
    def values(self) -> np.ndarray:
        return np.asarray(self.data)

    def axis(self, dim: str) -> int:
        try:
            return self.dims.index(dim)
        except ValueError as err:
            raise KeyError(f"Field has no dim {dim!r}; dims={self.dims}") from err

    def __repr__(self) -> str:
        return (
            f"Field(name={self.name!r}, dims={self.dims}, shape={self.shape}, "
            f"coords={list(self.coords)})"
        )

    # -- structural ops -----------------------------------------------------

    def copy(self, data: Any | None = None) -> "Field":
        return Field(
            self.data if data is None else data,
            self.dims,
            {k: Coord(c.dims, c.values) for k, c in self.coords.items()},
            dict(self.attrs),
            self.name,
        )

    def transpose(self, *dims: str) -> "Field":
        order = [self.axis(d) for d in dims]
        data = self.data.transpose(order)
        return Field(data, dims, self.coords, self.attrs, self.name)

    def isel(self, **indexers: Any) -> "Field":
        """Integer/array/slice selection along named dims."""
        index: list[Any] = [slice(None)] * len(self.dims)
        for dim, sel in indexers.items():
            index[self.axis(dim)] = sel
        data = self.data[tuple(index)]
        new_dims = tuple(
            d
            for d, sel in zip(self.dims, index)
            if not isinstance(sel, (int, np.integer))
        )
        new_coords: dict[str, Coord] = {}
        for cname, coord in self.coords.items():
            cvals = coord.values
            keep_dims = []
            for d in coord.dims:
                sel = index[self.axis(d)]
                caxis = len(keep_dims)
                cvals = np.asarray(cvals)[
                    (slice(None),) * caxis + (sel,)
                ]
                if not isinstance(sel, (int, np.integer)):
                    keep_dims.append(d)
            if keep_dims or coord.values.ndim == 0:
                new_coords[cname] = Coord(tuple(keep_dims), cvals)
        return Field(data, new_dims, new_coords, self.attrs, self.name)

    # -- reductions ---------------------------------------------------------

    def _reduce(self, fn_name: str, dim: str, **kwargs: Any) -> "Field":
        ax = self.axis(dim)
        data = getattr(self.data, fn_name)(axis=ax, **kwargs)
        new_dims = tuple(d for d in self.dims if d != dim)
        new_coords = {
            cname: coord
            for cname, coord in self.coords.items()
            if dim not in coord.dims
        }
        return Field(data, new_dims, new_coords, self.attrs, self.name)

    def mean(self, dim: str) -> "Field":
        return self._reduce("mean", dim)

    def std(self, dim: str, ddof: int = 0) -> "Field":
        return self._reduce("std", dim, ddof=ddof)

    # -- arithmetic with dim alignment -------------------------------------

    def _align_other(self, other: Any):
        if isinstance(other, Field):
            missing = [d for d in other.dims if d not in self.dims]
            if missing:
                raise ValueError(
                    f"Cannot broadcast dims {missing} against {self.dims}"
                )
            # reorder the other's dims to our order, then insert size-1
            # axes for our dims it lacks
            order = sorted(other.dims, key=self.dims.index)
            arr = other.data.transpose([other.axis(d) for d in order])
            present = set(order)
            expand_shape = [
                self.sizes[d] if d in present else 1 for d in self.dims
            ]
            return arr.reshape(expand_shape)
        return other

    def __sub__(self, other: Any) -> "Field":
        return self.copy(data=self.data - self._align_other(other))

    def __add__(self, other: Any) -> "Field":
        return self.copy(data=self.data + self._align_other(other))

    def __truediv__(self, other: Any) -> "Field":
        return self.copy(data=self.data / self._align_other(other))

    def __mul__(self, other: Any) -> "Field":
        return self.copy(data=self.data * self._align_other(other))


class FieldSet:
    """A collection of Fields sharing coordinates (~ xr.Dataset)."""

    def __init__(
        self,
        data_vars: Mapping[str, Field],
        attrs: Mapping[str, Any] | None = None,
    ):
        self.data_vars: dict[str, Field] = dict(data_vars)
        self.attrs: dict[str, Any] = dict(attrs or {})

    # -- access -------------------------------------------------------------

    @property
    def variables(self) -> list[str]:
        return list(self.data_vars)

    def __contains__(self, name: str) -> bool:
        return name in self.data_vars

    def __getitem__(self, key: str | list[str]) -> "Field | FieldSet":
        if isinstance(key, list):
            return FieldSet(
                {k: self.data_vars[k] for k in key}, attrs=self.attrs
            )
        return self.data_vars[key]

    def first(self) -> Field:
        return next(iter(self.data_vars.values()))

    @property
    def sizes(self) -> dict[str, int]:
        sizes: dict[str, int] = {}
        for field in self.data_vars.values():
            for d, n in field.sizes.items():
                if d in sizes and sizes[d] != n:
                    raise ValueError(f"Inconsistent sizes for dim {d}")
                sizes[d] = n
        return sizes

    def coord(self, name: str) -> Coord:
        for field in self.data_vars.values():
            if name in field.coords:
                return field.coords[name]
        raise KeyError(name)

    def __repr__(self) -> str:
        return f"FieldSet(vars={self.variables}, sizes={self.sizes})"

    # -- mapped ops ---------------------------------------------------------

    def map(self, fn) -> "FieldSet":
        return FieldSet(
            {name: fn(field) for name, field in self.data_vars.items()},
            attrs=self.attrs,
        )

    def isel(self, **indexers: Any) -> "FieldSet":
        return self.map(lambda f: f.isel(**indexers))

    def mean(self, dim: str) -> "FieldSet":
        return self.map(lambda f: f.mean(dim))

    def std(self, dim: str, ddof: int = 0) -> "FieldSet":
        return self.map(lambda f: f.std(dim, ddof=ddof))

    def _zip(self, other: Any, op: str) -> "FieldSet":
        if isinstance(other, FieldSet):
            return FieldSet(
                {
                    name: getattr(field, op)(other.data_vars[name])
                    for name, field in self.data_vars.items()
                },
                attrs=self.attrs,
            )
        return self.map(lambda f: getattr(f, op)(other))

    def __sub__(self, other: Any) -> "FieldSet":
        return self._zip(other, "__sub__")

    def __truediv__(self, other: Any) -> "FieldSet":
        return self._zip(other, "__truediv__")

    def __add__(self, other: Any) -> "FieldSet":
        return self._zip(other, "__add__")

    def __mul__(self, other: Any) -> "FieldSet":
        return self._zip(other, "__mul__")
