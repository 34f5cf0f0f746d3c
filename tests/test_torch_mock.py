"""Parity of the port's mock ERA5 generator, slicing, resampling and the
Field form of standardize with the JAX package's.

The cases of tests/test_01_mock_data.py and the slicing, resample,
standardize and space-coordinate cases of tests/test_02_transform.py,
each run through both packages on the same seed: the port's mock data
must be the JAX package's bit for bit (numpy draws on the host, numpy
``datetime64[ns]`` times), and each port function must select, or
compute, what the JAX function does on the same FieldSet.
"""

from __future__ import annotations

from datetime import datetime, timedelta

import numpy as np
import pytest

from dmd_era5_tpu.snapmat import create_mock_era5 as mock_jax
from dmd_era5_tpu.snapmat import create_mock_era5_svd as mock_svd_jax
from dmd_era5_tpu.snapmat import dataset_time_bounds as bounds_jax
from dmd_era5_tpu.snapmat import flatten_era5_variables as flatten_jax
from dmd_era5_tpu.snapmat import resample_era5_dataset as resample_jax
from dmd_era5_tpu.snapmat import slice_era5_dataset as slice_jax
from dmd_era5_tpu.snapmat import space_coord_to_level_lat_lon as split_jax
from dmd_era5_tpu.snapmat import standardize_data as standardize_jax
from dmd_era5_tpu.utils import FieldSet as FieldSetJax
from dmd_era5_tpu_torch.snapmat import create_mock_era5, create_mock_era5_svd
from dmd_era5_tpu_torch.snapmat import dataset_time_bounds, flatten_era5_variables
from dmd_era5_tpu_torch.snapmat import resample_era5_dataset, slice_era5_dataset
from dmd_era5_tpu_torch.snapmat import space_coord_to_level_lat_lon, standardize_data
from dmd_era5_tpu_torch.utils import FieldSet


def assert_attrs_equal(a: dict, b: dict):
    """Equal attrs; arrays (list attrs read back from HDF5) entry for entry."""
    assert sorted(a) == sorted(b)
    for key, value in b.items():
        if isinstance(value, np.ndarray) or isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], value)
        else:
            assert a[key] == value, key


def assert_fieldsets_equal(a, b):
    """Same variables, dims, data, coords and attrs, entry for entry.
    Times compare as instants: the port's are ``datetime64[ns]``, the
    JAX package's take pandas' unit (microseconds from pandas 3 on)."""
    assert a.variables == b.variables
    assert_attrs_equal(a.attrs, b.attrs)
    for name in b.variables:
        fa, fb = a[name], b[name]
        assert fa.dims == fb.dims and fa.name == fb.name
        assert_attrs_equal(fa.attrs, fb.attrs)
        assert np.asarray(fa.data).dtype == np.asarray(fb.data).dtype
        np.testing.assert_array_equal(np.asarray(fa.data), np.asarray(fb.data))
        assert sorted(fa.coords) == sorted(fb.coords)
        for cname, coord in fb.coords.items():
            assert fa.coords[cname].dims == coord.dims
            if coord.values.dtype.kind == "M":
                assert fa.coords[cname].values.dtype == np.dtype("datetime64[ns]")
            else:
                assert fa.coords[cname].values.dtype == coord.values.dtype
            np.testing.assert_array_equal(fa.coords[cname].values, coord.values)


def both(*args, **kwargs):
    return create_mock_era5(*args, **kwargs), mock_jax(*args, **kwargs)


# ------------------------------------------------ tests/test_01_mock_data.py


def test_grid_shape():
    fs, fs_j = both("2020-01-01", "2020-01-02", ["temperature"], [1000, 850], seed=0)
    assert_fieldsets_equal(fs, fs_j)
    t = fs["temperature"]
    assert t.dims == ("time", "level", "latitude", "longitude")
    assert t.sizes == {"time": 25, "level": 2, "latitude": 36, "longitude": 72}
    lats, lons = fs.coord("latitude").values, fs.coord("longitude").values
    assert lats[0] == 90 and lats[-1] == -85
    assert lons[0] == -180 and lons[-1] == 175
    assert fs.coord("time").values.dtype == np.dtype("datetime64[ns]")


def test_temperature_structure():
    fs, fs_j = both("2020-01-01", "2020-01-01T06", ["temperature"], [1000, 500], seed=1)
    assert_fieldsets_equal(fs, fs_j)
    data = fs["temperature"].values
    eq_row = np.argmin(np.abs(fs.coord("latitude").values))
    assert data[:, 1, eq_row, :].mean() < data[:, 0, eq_row, :].mean()
    assert np.abs(data[:, :, 0, :]).mean() < np.abs(data[:, :, eq_row, :]).mean()


def test_wind_and_generic_ranges():
    variables = ["u_component_of_wind", "v_component_of_wind", "geopotential"]
    fs, fs_j = both("2020-01-01", "2020-01-01T03", variables, [1000], seed=2)
    assert_fieldsets_equal(fs, fs_j)
    u = fs["u_component_of_wind"].values
    assert u.min() >= -10 and u.max() <= 10
    assert fs["u_component_of_wind"].attrs["units"] == "m/s"
    assert fs["geopotential"].attrs["units"] == "unknown"


def test_seed_determinism():
    a = create_mock_era5("2020-01-01", "2020-01-01T02", ["temperature"], [1000], seed=7)
    b = create_mock_era5("2020-01-01", "2020-01-01T02", ["temperature"], [1000], seed=7)
    np.testing.assert_array_equal(a["temperature"].values, b["temperature"].values)


def test_unseeded_draws_follow_the_global_state():
    """Without a seed both packages draw from ``np.random``'s global
    state, so one state gives one slice."""
    np.random.seed(11)
    fs = create_mock_era5("2020-01-01", "2020-01-01T02", ["temperature", "u_component_of_wind"], [1000])
    np.random.seed(11)
    fs_j = mock_jax("2020-01-01", "2020-01-01T02", ["temperature", "u_component_of_wind"], [1000])
    assert_fieldsets_equal(fs, fs_j)


@pytest.mark.parametrize("start,end", [
    ("2020-01-01T00:30", "2020-01-01T04"),
    (datetime(2019, 12, 31, 22), datetime(2020, 1, 1, 3)),
])
def test_times_off_the_hour_and_from_datetimes(start, end):
    fs, fs_j = both(start, end, ["temperature"], [1000], seed=3)
    assert_fieldsets_equal(fs, fs_j)


def test_mock_svd_shapes():
    kwargs = dict(variables=["temperature"], levels=[1000], delay_embedding=2, n_components=5, seed=3)
    U, s, V, coords, X = create_mock_era5_svd("2020-01-01", "2020-01-01T12", **kwargs)
    U_j, s_j, V_j, coords_j, X_j = mock_svd_jax("2020-01-01", "2020-01-01T12", **kwargs)
    n_space, t_out = 36 * 72, 13 - 1
    assert U.shape == (n_space * 2, 5) and s.shape == (5,) and V.shape == (5, t_out)
    assert X.shape == (n_space * 2, t_out)
    assert len(coords["time"].values) == t_out
    assert np.all(np.diff(s) <= 0)
    np.testing.assert_allclose(U @ np.diag(s) @ V, U @ U.T @ np.asarray(X.data), rtol=1e-8, atol=1e-8)
    # the same host arithmetic on the same data: the JAX oracle's factors
    np.testing.assert_array_equal(np.asarray(X.data), np.asarray(X_j.data))
    np.testing.assert_allclose(s, s_j, rtol=1e-12)
    np.testing.assert_allclose(U @ np.diag(s) @ V, U_j @ np.diag(s_j) @ V_j, atol=1e-9)
    assert sorted(coords) == sorted(coords_j)
    for name, coord in coords_j.items():
        np.testing.assert_array_equal(coords[name].values, coord.values)


# ------------------------------------------------ tests/test_02_transform.py


@pytest.fixture()
def mock_pair():
    args = ("2020-01-01", "2020-01-02", ["temperature", "u_component_of_wind"], [1000, 850])
    return create_mock_era5(*args, seed=11), mock_jax(*args, seed=11)


def test_time_bounds(mock_pair):
    fs, fs_j = mock_pair
    first, last = dataset_time_bounds(fs)
    assert (first, last) == bounds_jax(fs_j)
    assert type(first) is datetime and last == datetime(2020, 1, 2)


def test_slice_time_and_levels(mock_pair):
    fs, fs_j = mock_pair
    out = slice_era5_dataset(fs, "2020-01-01T06", "2020-01-01T12", levels=[850])
    assert out.sizes["time"] == 7
    assert list(out.coord("level").values) == [850]
    assert_fieldsets_equal(out, slice_jax(fs_j, "2020-01-01T06", "2020-01-01T12", levels=[850]))


@pytest.mark.parametrize("levels", [None, [1000], [850, 1000], [1000, 850]])
def test_slice_levels_as_the_jax_package(mock_pair, levels):
    fs, fs_j = mock_pair
    start, end = datetime(2020, 1, 1, 3), "2020-01-01T20"
    assert_fieldsets_equal(
        slice_era5_dataset(fs, start, end, levels=levels),
        slice_jax(fs_j, start, end, levels=levels),
    )


def test_slice_out_of_bounds(mock_pair):
    with pytest.raises(ValueError, match="outside dataset"):
        slice_era5_dataset(mock_pair[0], "2019-12-31", "2020-01-01T12")


def test_slice_bad_order(mock_pair):
    with pytest.raises(ValueError, match="before end"):
        slice_era5_dataset(mock_pair[0], "2020-01-01T12", "2020-01-01T06")


def test_slice_missing_level(mock_pair):
    with pytest.raises(ValueError, match="not available"):
        slice_era5_dataset(mock_pair[0], levels=[500])


def test_resample_stride(mock_pair):
    fs, fs_j = mock_pair
    out = resample_era5_dataset(fs, timedelta(hours=6))
    assert out.sizes["time"] == 5  # 0,6,12,18,24
    np.testing.assert_array_equal(out["temperature"].values, fs["temperature"].values[::6])
    assert_fieldsets_equal(out, resample_jax(fs_j, timedelta(hours=6)))


@pytest.mark.parametrize("hours", [1, 4, 5, 7, 24])
def test_resample_nearest_as_the_jax_package(mock_pair, hours):
    """Strides that do and do not divide the window; an irregular time
    axis (every third hour dropped) maps targets to nearest snapshots."""
    fs, fs_j = mock_pair
    assert_fieldsets_equal(resample_era5_dataset(fs, timedelta(hours=hours)),
                           resample_jax(fs_j, timedelta(hours=hours)))
    keep = np.array([i for i in range(25) if i % 3 != 2])
    assert_fieldsets_equal(resample_era5_dataset(fs.isel(time=keep), timedelta(hours=hours)),
                           resample_jax(fs_j.isel(time=keep), timedelta(hours=hours)))


def test_standardize_mean_center_only(mock_pair):
    fs, fs_j = mock_pair
    out, mean, std = standardize_data(fs, scale=False)
    assert std is None
    np.testing.assert_allclose(out["temperature"].mean("time").values, 0.0, atol=1e-10)
    np.testing.assert_allclose(mean["temperature"].values, fs["temperature"].values.mean(axis=0))
    out_j, mean_j, _ = standardize_jax(fs_j, scale=False)
    assert_fieldsets_equal(out, out_j)
    assert_fieldsets_equal(mean, mean_j)


def test_standardize_scale(mock_pair):
    fs, fs_j = mock_pair
    out, mean, std = standardize_data(fs, scale=True)
    np.testing.assert_allclose(out["temperature"].std("time").values, 1.0, atol=1e-10)
    assert std is not None
    for a, b in zip((out, mean, std), standardize_jax(fs_j, scale=True)):
        assert_fieldsets_equal(a, b)
    # a single Field, as the JAX function takes one
    f_out, f_mean, f_std = standardize_data(fs["temperature"])
    j_out, j_mean, j_std = standardize_jax(fs_j["temperature"])
    for a, b in ((f_out, j_out), (f_mean, j_mean), (f_std, j_std)):
        np.testing.assert_array_equal(a.values, b.values)
        assert a.dims == b.dims


def test_space_coord_to_level_lat_lon(mock_pair):
    fs, fs_j = mock_pair
    out = space_coord_to_level_lat_lon(FieldSet({"X": flatten_era5_variables(fs)}))
    out_j = split_jax(FieldSetJax({"X": flatten_jax(fs_j)}))
    assert_fieldsets_equal(out, out_j)
    x = out["X"]
    np.testing.assert_array_equal(x.coords["space"].values, np.arange(x.sizes["space"]))
    assert x.coords["level"].values[0] == 1000
    assert x.coords["latitude"].values[0] == 90
    assert x.coords["longitude"].values[0] == -180
    again = space_coord_to_level_lat_lon(out)
    np.testing.assert_array_equal(again["X"].coords["space"].values, x.coords["space"].values)
    with pytest.raises(ValueError, match="'space' coordinate"):
        space_coord_to_level_lat_lon(fs)
