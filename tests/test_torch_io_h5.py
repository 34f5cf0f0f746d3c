"""Parity of the port's HDF5 FieldSet files with the JAX package's.

The HDF5 cases of tests/test_06_pipeline.py on the port's writer and
reader, and the cross-package cases: a file written by either package
loads in the other, equal entry for entry, and the two writers give one
FieldSet the same file to a reader (h5py sees the same objects, types,
values and scales in both; the bytes differ, since the port's codec
places objects where libhdf5 does not), the port's writer one md5 each
time, and a field written from a tensor slab by slab the port's bytes of
the same field from numpy.
"""

from __future__ import annotations

import h5py
import numpy as np
import pytest
import torch
from test_torch_mock import assert_attrs_equal, assert_fieldsets_equal
from torch_h5_compare import assert_same_to_a_reader

from dmd_era5_tpu.snapmat import create_mock_era5 as mock_jax
from dmd_era5_tpu.utils import io_h5 as io_jax
from dmd_era5_tpu.utils import labels as labels_jax
from dmd_era5_tpu_torch.pipeline.artifacts import file_md5
from dmd_era5_tpu_torch.snapmat import create_mock_era5, flatten_era5_variables
from dmd_era5_tpu_torch.snapmat import space_coord_to_level_lat_lon
from dmd_era5_tpu_torch.utils import io_h5
from dmd_era5_tpu_torch.utils.io_h5 import load_fieldset, save_fieldset
from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet


def to_jax(fs: FieldSet):
    """The same FieldSet built of the JAX package's containers."""
    return labels_jax.FieldSet(
        {
            name: labels_jax.Field(
                np.asarray(f.data), f.dims,
                {c: labels_jax.Coord(co.dims, co.values) for c, co in f.coords.items()},
                f.attrs, f.name,
            )
            for name, f in fs.data_vars.items()
        },
        attrs=fs.attrs,
    )


def svd_like() -> FieldSet:
    """A flattened, split FieldSet with auxiliary coords, a
    coordinate-less dim and attrs of every encoded kind."""
    fs = create_mock_era5("2020-01-01", "2020-01-01T05", ["temperature", "u_component_of_wind"],
                          [1000, 850], seed=4)
    x = flatten_era5_variables(fs)
    rng = np.random.default_rng(5)
    u = Field(rng.standard_normal((x.sizes["space"], 3)).astype(np.float32), ("space", "components"),
              {"space": x.coords["space"], "original_variable": x.coords["original_variable"]},
              {"note": "factor", "flags": [1, 2], "names": ["a", "b"], "none": None,
               "nested": {"k": [1, 2]}, "on": True}, "U")
    x.attrs.update(levels=[1000, 850], scale=0, ratio=0.25)
    out = FieldSet({"X": x, "U": u}, attrs={"source_path": "mock_data", "n_components": 3,
                                             "variables": ["temperature", "u_component_of_wind"]})
    return space_coord_to_level_lat_lon(out)


def slice_fs() -> FieldSet:
    fs = create_mock_era5("2020-01-01", "2020-01-01T05", ["temperature"], [1000], seed=0)
    fs.attrs["variables"] = ["temperature"]
    fs.attrs["levels"] = [1000]
    return fs


# --------------------------------------------- tests/test_06_pipeline.py


def test_h5_roundtrip_dataset(tmp_path):
    fs = slice_fs()
    save_fieldset(fs, tmp_path / "slice.h5")
    back = load_fieldset(tmp_path / "slice.h5")
    assert back.variables == ["temperature"]
    np.testing.assert_array_equal(back["temperature"].values, fs["temperature"].values)
    np.testing.assert_array_equal(back.coord("time").values, fs.coord("time").values)
    assert back.attrs["variables"] == ["temperature"]
    assert back["temperature"].dims == ("time", "level", "latitude", "longitude")


def test_h5_string_coords_roundtrip(tmp_path):
    fs = create_mock_era5("2020-01-01", "2020-01-01T03", ["temperature"], [1000], seed=0)
    out = space_coord_to_level_lat_lon(FieldSet({"X": flatten_era5_variables(fs)}))
    save_fieldset(out, tmp_path / "x.h5")
    x = load_fieldset(tmp_path / "x.h5")["X"]
    assert x.coords["original_variable"].values[0] == "temperature"
    np.testing.assert_array_equal(x.coords["latitude"].values, out["X"].coords["latitude"].values)


def test_h5_layout_is_netcdf4_compatible(tmp_path):
    """Root-level variables, dimension scales attached through
    DIMENSION_LIST, hidden scales for coordinate-less dims, the CF
    ``coordinates`` list and CF time units, as the JAX writer lays out."""
    fs = create_mock_era5("2020-01-01", "2020-01-01T05", ["temperature"], [1000], seed=0)
    out = space_coord_to_level_lat_lon(FieldSet({"X": flatten_era5_variables(fs)}))
    path = tmp_path / "x.h5"
    save_fieldset(out, path)
    with h5py.File(path, "r") as f:
        assert "X" in f and isinstance(f["X"], h5py.Dataset)
        assert "vars" not in f and "coords" not in f
        x = f["X"]
        assert "DIMENSION_LIST" in x.attrs
        time_scale = f["time"]
        assert time_scale.attrs["CLASS"] == b"DIMENSION_SCALE"
        assert x.dims[1][0] == time_scale
        assert time_scale.attrs["units"] == "nanoseconds since 1970-01-01"
        assert time_scale.dtype == np.int64
        listed = x.attrs["coordinates"]
        listed = listed.decode() if isinstance(listed, bytes) else listed
        assert "original_variable" in listed.split()
    back = load_fieldset(path)
    np.testing.assert_array_equal(back["X"].values, out["X"].values)
    assert back["X"].dims == out["X"].dims
    assert back["X"].coords["original_variable"].values[0] == "temperature"

    anon = FieldSet({"Y": Field(np.zeros((4, 3), np.float32), ("space", "anon"),
                                {"space": Coord("space", np.arange(4))}, name="Y")})
    save_fieldset(anon, tmp_path / "y.h5")
    with h5py.File(tmp_path / "y.h5", "r") as f:
        assert f["anon"].attrs["NAME"].startswith(
            b"This is a netCDF dimension but not a netCDF variable.")
        assert f["Y"].dims[1][0] == f["anon"]
    back2 = load_fieldset(tmp_path / "y.h5")
    assert "anon" not in back2["Y"].coords
    assert back2["Y"].dims == ("space", "anon")


def test_corrupt_artifact_fails_loudly(tmp_path):
    path = tmp_path / "bad.h5"
    path.write_bytes(b"not an hdf5 file")
    with pytest.raises(OSError):
        load_fieldset(path)


# ------------------------------------------------------- across packages


@pytest.mark.parametrize("make", [slice_fs, svd_like], ids=["slice", "svd_like"])
def test_files_cross_between_packages(tmp_path, make):
    fs = make()
    save_fieldset(fs, tmp_path / "port.h5")
    io_jax.save_fieldset(to_jax(fs), tmp_path / "jax.h5")
    from_port_in_jax = io_jax.load_fieldset(tmp_path / "port.h5")
    from_jax_in_port = load_fieldset(tmp_path / "jax.h5")
    assert_fieldsets_equal(from_jax_in_port, from_port_in_jax)
    assert_fieldsets_equal(load_fieldset(tmp_path / "port.h5"), from_jax_in_port)
    assert_attrs_equal(from_jax_in_port.attrs, fs.attrs)
    for name in fs.variables:
        np.testing.assert_array_equal(from_jax_in_port[name].values, np.asarray(fs[name].data))
        assert_attrs_equal(from_jax_in_port[name].attrs, fs[name].attrs)


@pytest.mark.parametrize("make", [slice_fs, svd_like], ids=["slice", "svd_like"])
def test_one_fieldset_gives_both_writers_the_same_bytes(tmp_path, make):
    fs = make()
    save_fieldset(fs, tmp_path / "port.h5")
    save_fieldset(fs, tmp_path / "port_again.h5")
    io_jax.save_fieldset(to_jax(fs), tmp_path / "jax.h5")
    assert_same_to_a_reader(tmp_path / "port.h5", tmp_path / "jax.h5")
    assert file_md5(tmp_path / "port.h5") == file_md5(tmp_path / "port_again.h5")


@pytest.mark.parametrize("slab_bytes", [1 << 28, 4096])
def test_tensor_fields_are_written_in_slabs_to_the_same_bytes(tmp_path, monkeypatch, slab_bytes):
    """A field holding a (non-contiguous) tensor is written slab by slab
    along its first axis; the file is the one a numpy field gives, byte
    for byte, and to a reader the JAX writer's."""
    monkeypatch.setattr(io_h5, "_SLAB_BYTES", slab_bytes)
    fs = slice_fs()
    field = fs["temperature"]
    t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(field.data, 0, -1))).permute(3, 0, 1, 2)
    assert not t.is_contiguous()
    on_tensor = FieldSet({"temperature": field.copy(data=t)}, attrs=fs.attrs)
    save_fieldset(on_tensor, tmp_path / "tensor.h5")
    save_fieldset(fs, tmp_path / "numpy.h5")
    io_jax.save_fieldset(to_jax(fs), tmp_path / "jax.h5")
    assert file_md5(tmp_path / "tensor.h5") == file_md5(tmp_path / "numpy.h5")
    assert_same_to_a_reader(tmp_path / "tensor.h5", tmp_path / "jax.h5")


@pytest.mark.parametrize("unit", ["s", "us", "ns"])
def test_times_of_any_unit_load_as_ns_in_both(tmp_path, unit):
    times = (np.datetime64("2019-01-01T00", "h") + np.arange(4)).astype(f"datetime64[{unit}]")
    fs = FieldSet({"v": Field(np.arange(4.0), ("time",), {"time": Coord("time", times)}, name="v")})
    save_fieldset(fs, tmp_path / "t.h5")
    for loader in (load_fieldset, io_jax.load_fieldset):
        back = loader(tmp_path / "t.h5").coord("time").values
        assert back.dtype == np.dtype("datetime64[ns]")
        np.testing.assert_array_equal(back, times)


def test_legacy_grouped_layout_loads_in_both(tmp_path):
    path = tmp_path / "legacy.h5"
    with h5py.File(path, "w") as f:
        f.attrs["variables"] = np.asarray(["temperature"], dtype=h5py.string_dtype())
        f.attrs["none"] = "__none__"
        c = f.create_group("coords")
        t = c.create_dataset("time", data=np.arange(3, dtype=np.int64) * 3_600_000_000_000)
        t.attrs["dims"] = np.asarray(["time"], dtype=h5py.string_dtype())
        t.attrs["units"] = "nanoseconds since 1970-01-01"
        s = c.create_dataset("space", data=np.arange(2))
        s.attrs["dims"] = np.asarray(["space"], dtype=h5py.string_dtype())
        v = f.create_group("vars").create_dataset("X", data=np.ones((2, 3), np.float32))
        v.attrs["dims"] = np.asarray(["space", "time"], dtype=h5py.string_dtype())
        v.attrs["attr_note"] = "legacy"
    back, back_j = load_fieldset(path), io_jax.load_fieldset(path)
    assert_fieldsets_equal(back, back_j)
    assert back.attrs == {"variables": ["temperature"], "none": None}
    assert back["X"].attrs == {"note": "legacy"}
    assert back.coord("time").values.dtype == np.dtype("datetime64[ns]")


def test_jax_mock_slice_loads_in_the_port(tmp_path):
    fs_j = mock_jax("2020-01-01", "2020-01-01T05", ["temperature"], [1000, 850], seed=9)
    io_jax.save_fieldset(fs_j, tmp_path / "j.h5")
    back = load_fieldset(tmp_path / "j.h5")
    np.testing.assert_array_equal(back["temperature"].values, fs_j["temperature"].values)
    np.testing.assert_array_equal(back.coord("time").values, fs_j.coord("time").values)
