"""The port's HDF5 reader (``dmd_era5_tpu_torch/utils/hdf5.py``) on the
files that h5py and netCDF-4 write, held to h5py.

Every file is written by h5py at run time, small.  The structure cases
cover what netCDF-C, h5netcdf and ``libver="latest"`` write: version 2
object headers with creation order tracked, new-style groups with
compact and dense links, dense attributes, superblocks of versions 2
and 3, the filter pipeline (deflate, shuffle, fletcher32; a chunk's
filter mask; big-endian data; unwritten chunks) and each chunk index of
the version 4 layout.  Each case holds the port's ``hdf5.File`` to
h5py (the same keys in the same order, attributes, dtypes up to byte
order, values bit for bit), and the port's ``load_fieldset`` to the JAX
package's where the file holds a FieldSet.  Then the entry points that
read foreign files (DMDc's control series, ``read_packed_rows``, the LM
checkpoint) on compressed, creation-order-tracked files against the JAX
package's functions, and the refusals: filters outside the three, a soft
link, a flipped byte in a version 2 object header and in a fletcher32
chunk.  Last, ``tests/torch_nc4_writer.py`` (which writes the netCDF-4
layout for chip_smoke's phase 16h) held to h5py and to both packages'
``load_fieldset``.
"""

from __future__ import annotations

import h5py
import numpy as np
import pytest
import torch
from test_torch_mock import assert_fieldsets_equal
from torch_nc4_writer import write_nc4_fieldset

from dmd_era5_tpu.pipeline import era5_dmd as era5_dmd_jax
from dmd_era5_tpu.snapmat import loader as loader_jax
from dmd_era5_tpu.utils import checkpoint as checkpoint_jax
from dmd_era5_tpu.utils import io_h5 as io_jax
from dmd_era5_tpu.utils import labels as labels_jax
from dmd_era5_tpu_torch.pipeline import era5_dmd
from dmd_era5_tpu_torch.snapmat import create_mock_era5, loader
from dmd_era5_tpu_torch.utils import checkpoint, hdf5, io_h5
from dmd_era5_tpu_torch.utils.labels import Field

NS = "nanoseconds since 1970-01-01"


# ------------------------------------------------------------ holding to h5py


def _plain_h5py(f: h5py.File, value, nested: bool = False):
    if isinstance(value, h5py.Reference):
        return ("ref", f[value].name)
    if isinstance(value, (bytes, np.bytes_)):
        return value.decode()
    if isinstance(value, np.ndarray):
        if value.dtype.names:
            return (value.shape, [[_plain_h5py(f, x) for x in row]
                                  for row in value.reshape(-1).tolist()])
        if value.dtype.kind in "OS":
            items = [_plain_h5py(f, v, True) for v in value.reshape(-1).tolist()]
            return items if nested else (value.shape, items)  # DIMENSION_LIST's sequences
        return ("array", value.dtype.newbyteorder("="), value.shape,
                value.astype(value.dtype.newbyteorder("=")).tobytes())
    if isinstance(value, np.generic):
        return ("scalar", value.dtype.newbyteorder("="), value.tobytes())
    if isinstance(value, (list, tuple)):
        return [_plain_h5py(f, v) for v in value]
    return value


def _plain_port(f: hdf5.File, value):
    if isinstance(value, hdf5.Reference):
        return ("ref", f._path_of(value))
    if isinstance(value, np.ndarray):
        if value.dtype.kind == "O":
            return (value.shape, [_plain_port(f, v) for v in value.reshape(-1).tolist()])
        return ("array", value.dtype, value.shape, value.tobytes())
    if isinstance(value, np.generic):
        return ("scalar", value.dtype, value.tobytes())
    if isinstance(value, (list, tuple)):
        return [_plain_port(f, v) for v in value]
    return value


def _h5py_string_values(ds: h5py.Dataset):
    values = ds.asstr()[()]
    return values if isinstance(values, str) else np.asarray(values, object)


def assert_reads_as_h5py(path) -> None:
    """The port's reader sees what h5py sees in the file at ``path``: the
    same objects, keys in the same order, attributes in the same order
    with the same values, each dataset's shape, dtype (up to byte order)
    and values bit for bit."""
    with h5py.File(path, "r") as fa, hdf5.File(path, "r") as fb:
        def walk(ga: h5py.Group, gb: hdf5.Group):
            assert list(ga.keys()) == gb.keys(), (ga.name, list(ga.keys()), gb.keys())
            for obj_a, obj_b in [(ga, gb)] + [(ga[k], gb[k]) for k in ga.keys()]:
                assert list(obj_a.attrs.keys()) == obj_b.attrs.keys(), obj_a.name
                for key in obj_a.attrs.keys():
                    assert _plain_h5py(fa, obj_a.attrs[key]) == _plain_port(fb, obj_b.attrs[key]), \
                        (obj_a.name, key)
            for key in ga.keys():
                a, b = ga[key], gb[key]
                if isinstance(a, h5py.Group):
                    assert isinstance(b, hdf5.Group)
                    walk(a, b)
                    continue
                assert isinstance(b, hdf5.Dataset) and a.shape == b.shape, a.name
                if h5py.check_string_dtype(a.dtype) is not None:
                    assert _plain_h5py(fa, _h5py_string_values(a)) == _plain_port(fb, b[()])
                    continue
                assert a.dtype.newbyteorder("=") == b.dtype, (a.name, a.dtype, b.dtype)
                va, vb = a[()], b[()]
                assert np.asarray(va).astype(b.dtype).tobytes() == np.asarray(vb).tobytes(), a.name
                if a.ndim and a.shape[0] > 2:
                    np.testing.assert_array_equal(b[1:-1], va[1:-1])

        walk(fa, fb)


def _native(fs):
    """A FieldSet of the JAX package's with its arrays in native byte
    order (the port reads numbers so, as torch takes them)."""
    def native(values):
        values = np.asarray(values)
        return values.astype(values.dtype.newbyteorder("=")) if values.dtype.kind in "iuf" else values

    return labels_jax.FieldSet(
        {name: labels_jax.Field(native(f.data), f.dims,
                                {c: labels_jax.Coord(co.dims, native(co.values))
                                 for c, co in f.coords.items()}, f.attrs, f.name)
         for name, f in fs.data_vars.items()}, attrs=fs.attrs)


def assert_fieldset_parity(path) -> None:
    """The port's ``load_fieldset`` equals the JAX package's, numbers in
    native byte order."""
    assert_fieldsets_equal(io_h5.load_fieldset(path), _native(io_jax.load_fieldset(path)))


# ------------------------------------------------------------ netCDF-4-like files by h5py


def _fieldset_file(path, file_kw=None, var_kw=None, n_attrs=2, dtype="f4", shape=(6, 5, 8),
                   write=None):
    """A FieldSet file as netCDF-4 lays one out, written by h5py with
    ``file_kw`` and the variable's ``var_kw``: time, latitude and
    longitude dimension scales (times CF int64), one ``temperature``
    variable with ``n_attrs`` attributes, its scales attached."""
    rng = np.random.default_rng(sum(shape) + n_attrs)
    values = (rng.standard_normal(shape) * 10 + 270).astype(dtype)
    times = (np.datetime64("2019-01-01T00", "ns")
             + np.arange(shape[0]) * np.timedelta64(3600, "s")).astype(np.int64)
    coords = {"time": times, "latitude": np.linspace(90, -90, shape[1]).astype("f4"),
              "longitude": np.linspace(0, 359, shape[2]).astype("f4")}
    with h5py.File(path, "w", **(file_kw or {})) as f:
        f.attrs["source_path"] = "gs://bucket/era5.zarr"
        f.attrs["levels"] = np.asarray([1000])
        for name, data in coords.items():
            ds = f.create_dataset(name, data=data)
            ds.make_scale(name)
            if name == "time":
                ds.attrs["units"] = NS
        kw = dict(var_kw or {})
        if write is None:
            v = f.create_dataset("temperature", data=values, **kw)
        else:
            v = f.create_dataset("temperature", shape=shape, dtype=dtype, **kw)
            write(v, values)
        for i, name in enumerate(coords):
            v.dims[i].attach_scale(f[name])
        v.attrs["units"] = "K"
        for i in range(n_attrs - 1):
            v.attrs[f"note_{i:02d}"] = f"attribute {i}" if i % 2 else np.float32(i)
    return values


GZIP = dict(chunks=(2, 5, 4), compression="gzip", shuffle=True)
# the nine probe files: h5py's options for the file and the variable
PROBES = {
    "default": ({}, {}),
    "track_order": (dict(track_order=True), {}),
    "gzip_shuffle": ({}, GZIP),
    "gzip_shuffle_fletcher32": ({}, dict(GZIP, fletcher32=True)),
    "12_attrs_track_order": (dict(track_order=True), dict(track_order=True)),
    "latest": (dict(libver="latest"), {}),
    "latest_chunked": (dict(libver="latest"), dict(chunks=(2, 5, 4))),
    "latest_unlimited": (dict(libver="latest"), dict(chunks=(2, 5, 4), maxshape=(None, 5, 8))),
    "earliest_latest_track_gzip": (dict(libver=("earliest", "latest"), track_order=True), GZIP),
}


@pytest.mark.parametrize("probe", list(PROBES))
def test_probe_files_read_as_h5py_reads_them(tmp_path, probe):
    file_kw, var_kw = PROBES[probe]
    values = _fieldset_file(tmp_path / "p.h5", file_kw, var_kw,
                            n_attrs=12 if probe.startswith("12") else 2)
    assert_reads_as_h5py(tmp_path / "p.h5")
    assert_fieldset_parity(tmp_path / "p.h5")
    fs = io_h5.load_fieldset(tmp_path / "p.h5")
    np.testing.assert_array_equal(fs["temperature"].data, values)
    assert fs["temperature"].dims == ("time", "latitude", "longitude")


def _superblock_version(path) -> int:
    return path.read_bytes()[8]


@pytest.mark.parametrize("libver,version", [(("v108", "v108"), 2), ("latest", 3)],
                         ids=["superblock_2", "superblock_3"])
def test_superblocks_of_versions_2_and_3(tmp_path, libver, version):
    _fieldset_file(tmp_path / "s.h5", dict(libver=libver, track_order=True), GZIP)
    assert _superblock_version(tmp_path / "s.h5") == version
    assert_reads_as_h5py(tmp_path / "s.h5")
    assert_fieldset_parity(tmp_path / "s.h5")


@pytest.mark.parametrize("n", [9, 40, 400], ids=["9_links", "40_links", "400_links"])
@pytest.mark.parametrize("file_kw", [dict(track_order=True), dict(libver="latest")],
                         ids=["track_order", "latest"])
def test_dense_links(tmp_path, n, file_kw):
    """Past 8 links a new-style group keeps them in a fractal heap
    indexed by a version 2 B-tree (400: indirect heap blocks, an
    internal B-tree node)."""
    with h5py.File(tmp_path / "g.h5", "w", **file_kw) as f:
        g = f.create_group("many")
        for i in reversed(range(n)):
            g.create_dataset(f"d{i:03d}", data=np.arange(i % 7 + 1, dtype="i2"))
        g.attrs["n"] = n
        f.create_group("few").create_dataset("x", data=np.ones(2))
    assert_reads_as_h5py(tmp_path / "g.h5")
    with hdf5.File(tmp_path / "g.h5", "r") as f:
        assert len(f["many"]) == n


@pytest.mark.parametrize("n", [9, 30, 200], ids=["9_attrs", "30_attrs", "200_attrs"])
@pytest.mark.parametrize("kw", [dict(track_order=True), dict(libver="latest")],
                         ids=["track_order", "latest"])
def test_dense_attributes(tmp_path, n, kw):
    """Past 8 attributes a version 2 object header keeps them in a
    fractal heap indexed by a version 2 B-tree (record type 8)."""
    _fieldset_file(tmp_path / "a.h5", kw, dict(track_order=kw.get("track_order")), n_attrs=n)
    assert_reads_as_h5py(tmp_path / "a.h5")
    assert_fieldset_parity(tmp_path / "a.h5")


def test_a_huge_attribute_in_dense_storage(tmp_path):
    """An attribute past the fractal heap's managed size is a huge object,
    stored at its own address."""
    with h5py.File(tmp_path / "h.h5", "w", libver="latest") as f:
        ds = f.create_dataset("x", data=np.arange(4.0))
        for i in range(10):
            ds.attrs[f"a{i}"] = i
        ds.attrs["big"] = np.arange(30000, dtype="f8")
    assert_reads_as_h5py(tmp_path / "h.h5")


@pytest.mark.parametrize("kw", [{}, dict(chunks=(2, 5, 4)), GZIP], ids=["contiguous", "chunked",
                                                                      "gzip"])
def test_big_endian_data(tmp_path, kw):
    values = _fieldset_file(tmp_path / "b.h5", dict(track_order=True), kw, dtype=">f4")
    assert_reads_as_h5py(tmp_path / "b.h5")
    assert_fieldset_parity(tmp_path / "b.h5")
    np.testing.assert_array_equal(io_h5.load_fieldset(tmp_path / "b.h5")["temperature"].data,
                                  values)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_a_chunk_with_its_filter_mask_set(tmp_path, libver):
    """A chunk written raw with deflate's bit of its filter mask set is
    read raw, the other chunks inflated."""
    values = np.arange(60, dtype="<i4").reshape(6, 10)
    with h5py.File(tmp_path / "m.h5", "w", libver=libver) as f:
        ds = f.create_dataset("x", data=values, chunks=(2, 10), compression="gzip")
        ds.id.write_direct_chunk((2, 0), values[2:4].tobytes(), filter_mask=1)
    assert_reads_as_h5py(tmp_path / "m.h5")


@pytest.mark.parametrize("kw", [dict(chunks=(2, 4)), dict(chunks=(2, 4), compression="gzip"),
                                dict(chunks=(2, 4), maxshape=(None, 9), compression="gzip",
                                     shuffle=True, fletcher32=True)],
                         ids=["chunked", "gzip", "unlimited_filtered"])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_unwritten_chunks_read_as_the_fill_value(tmp_path, kw, libver):
    with h5py.File(tmp_path / "u.h5", "w", libver=libver) as f:
        ds = f.create_dataset("x", shape=(7, 9), dtype="f4", fillvalue=-7.5, **kw)
        ds[2:4, 0:4] = 1.25
        ds[6, 8] = 3.0
    assert_reads_as_h5py(tmp_path / "u.h5")
    with hdf5.File(tmp_path / "u.h5", "r") as f:
        assert f["x"][()][0, 0] == -7.5 and f["x"][()][6, 8] == 3.0


def _early_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


# (shape, h5py's options, the chunk index's type in the layout message)
INDICES = {
    "single_chunk": ((6, 10), dict(chunks=(6, 10)), 1),
    "single_chunk_gzip": ((6, 10), dict(chunks=(6, 10), compression="gzip", shuffle=True), 1),
    "implicit": ((6, 10), dict(chunks=(4, 3), dcpl=_early_dcpl), 2),
    "fixed_array": ((12, 10), dict(chunks=(5, 3)), 3),
    "fixed_array_gzip": ((12, 10), dict(chunks=(5, 3), compression="gzip"), 3),
    "fixed_array_paged": ((50, 50), dict(chunks=(1, 2)), 3),
    "fixed_array_paged_gzip": ((50, 50), dict(chunks=(1, 2), compression="gzip",
                                              fletcher32=True), 3),
    "extensible_array": ((40, 6), dict(chunks=(1, 4), maxshape=(None, 6)), 4),
    "extensible_array_gzip": ((40, 6), dict(chunks=(1, 4), maxshape=(None, 6),
                                            compression="gzip", shuffle=True), 4),
    "extensible_array_last_dim": ((5, 300), dict(chunks=(2, 3), maxshape=(8, None)), 4),
    "btree2": ((9, 7), dict(chunks=(2, 2), maxshape=(None, None)), 5),
    "btree2_gzip": ((30, 30), dict(chunks=(1, 2), maxshape=(None, None), compression="gzip",
                                   shuffle=True), 5),
}


@pytest.mark.parametrize("case", list(INDICES))
def test_version_4_layout_chunk_indices(tmp_path, case):
    shape, kw, kind = INDICES[case]
    kw = dict(kw)
    if "dcpl" in kw:
        kw["dcpl"] = kw["dcpl"]()
    values = np.random.default_rng(kind).standard_normal(shape).astype("f4")
    with h5py.File(tmp_path / "c.h5", "w", libver="latest") as f:
        f.create_dataset("x", data=values, **kw)
    with hdf5.File(tmp_path / "c.h5", "r") as f:
        layout = f["x"]._meta()
        assert layout.index == {1: "single", 2: "implicit", 3: "farray", 4: "earray",
                                5: "btree2"}[kind]
    assert_reads_as_h5py(tmp_path / "c.h5")


def test_compact_layout(tmp_path):
    with h5py.File(tmp_path / "k.h5", "w") as f:
        f.create_dataset("x", data=np.arange(12, dtype="i8").reshape(3, 4), dcpl=_compact_dcpl())
    assert_reads_as_h5py(tmp_path / "k.h5")


def test_rows_of_a_compressed_dataset_into_a_buffer(tmp_path):
    """``read_direct`` and row slices over chunks that straddle the rows
    asked for: each chunk decoded whole, its rows copied out."""
    values = np.random.default_rng(3).standard_normal((23, 7)).astype("f4")
    with h5py.File(tmp_path / "r.h5", "w", track_order=True) as f:
        f.create_dataset("X", data=values, chunks=(5, 3), compression="gzip", shuffle=True)
    with hdf5.File(tmp_path / "r.h5", "r") as f:
        for r0, r1 in ((0, 23), (3, 4), (4, 16), (22, 23)):
            dest = np.empty((r1 - r0, 7), "f4")
            f["X"].read_direct(dest, np.s_[r0:r1, :])
            np.testing.assert_array_equal(dest, values[r0:r1])
            np.testing.assert_array_equal(f["X"][r0:r1], values[r0:r1])


# ------------------------------------------------------------ the entry points


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_control_series_from_a_compressed_file(tmp_path, libver):
    times = np.datetime64("2019-01-01T00", "ns") + np.arange(10) * np.timedelta64(3600, "s")
    series = np.random.default_rng(1).standard_normal((2, 10)).astype("f4")
    path = str(tmp_path / "control.h5")
    with h5py.File(path, "w", libver=libver, track_order=True) as f:
        f.create_dataset("control", data=series, chunks=(1, 4), compression="gzip", shuffle=True)
        for i in range(10):
            f.attrs[f"a{i}"] = i
    got = era5_dmd._control_series(path, times)
    np.testing.assert_array_equal(got, era5_dmd_jax._control_series(path, times))
    np.testing.assert_array_equal(got, series[:, :-1])


def _packed_file(path, libver):
    x = np.random.default_rng(2).standard_normal((50, 9)).astype("f4")
    with h5py.File(path, "w", libver=libver, track_order=True) as f:
        f.create_dataset("X", data=x, chunks=(8, 9), compression="gzip", shuffle=True)
        f.attrs["bf16"] = 0
    return x


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_read_packed_rows_from_a_compressed_file(tmp_path, libver):
    path = str(tmp_path / "x.h5")
    x = _packed_file(path, libver)
    for r0, r1 in ((0, 50), (7, 9), (13, 41)):
        want = loader_jax.read_packed_rows(path, r0, r1)
        np.testing.assert_array_equal(loader.read_packed_rows(path, r0, r1), want)
        held = []

        def into(shape, dtype):
            held.append(np.full(shape, np.nan, dtype))
            return held[0]

        np.testing.assert_array_equal(loader.read_packed_rows(path, r0, r1, into=into), want)
        np.testing.assert_array_equal(held[0], x[r0:r1])
    assert loader.packed_info(path)[0] == (50, 9) and not loader.packed_info(path)[2]


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_lm_checkpoint_from_a_compressed_file(tmp_path, libver):
    """An LM state checkpoint (``save_pytree``'s layout) as h5py writes
    it with creation order tracked and its leaves compressed."""
    path = tmp_path / "lm.h5"
    leaves = [np.linspace(-1, 1, 40, dtype="f4").reshape(8, 5), np.float32(0.25), np.int32(7),
              np.bool_(True)]
    with h5py.File(path, "w", libver=libver, track_order=True) as f:
        f.attrs["treedef"] = "PyTreeDef((*, *, *, *))"
        f.attrs["n_leaves"] = len(leaves)
        f.attrs["metadata"] = '{"iteration": 3}'
        for i, leaf in enumerate(leaves):
            kw = dict(chunks=(4, 5), compression="gzip", shuffle=True) if np.ndim(leaf) else {}
            f.create_dataset(f"leaf_{i}", data=leaf, **kw)
    got, meta = checkpoint.load_pytree(path)
    want, meta_j = checkpoint_jax.load_pytree(path)
    assert meta == meta_j == {"iteration": 3}
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ refusals


def _nbit_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((10,))
    dcpl.set_filter(h5py.h5z.FILTER_NBIT, h5py.h5z.FLAG_OPTIONAL, ())
    return dcpl


@pytest.mark.parametrize("kw,name", [(dict(compression="lzf", chunks=(10,)), "lzf"),
                                     (dict(scaleoffset=0, chunks=(10,)), "scaleoffset"),
                                     (dict(dcpl=_nbit_dcpl), "nbit")],
                         ids=["lzf", "scaleoffset", "nbit"])
def test_filters_outside_the_three_are_refused_by_name(tmp_path, kw, name):
    kw = {k: v() if k == "dcpl" else v for k, v in kw.items()}
    with h5py.File(tmp_path / "z.h5", "w") as f:
        f.create_dataset("x", data=np.arange(100, dtype="i4"), **kw)
    with hdf5.File(tmp_path / "z.h5", "r") as f, pytest.raises(hdf5.HDF5Error,
                                                               match=rf"{name} \(id \d+\)"):
        f["x"][()]


def test_a_soft_link_is_refused_by_name(tmp_path):
    with h5py.File(tmp_path / "l.h5", "w", track_order=True) as f:
        f.create_dataset("x", data=np.arange(3))
        f["alias"] = h5py.SoftLink("/x")
    with hdf5.File(tmp_path / "l.h5", "r") as f, pytest.raises(hdf5.HDF5Error,
                                                               match="soft link 'alias'"):
        f.keys()


def test_a_flipped_byte_in_an_object_header_fails_its_checksum(tmp_path):
    path = tmp_path / "o.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3))
        f["x"].attrs["note"] = np.int64(0x1122334455667788)
    raw = bytearray(path.read_bytes())
    at = raw.index(np.int64(0x1122334455667788).tobytes())
    raw[at] ^= 0x20
    path.write_bytes(bytes(raw))
    with pytest.raises(hdf5.HDF5Error, match=r"version 2 object header \(OHDR\) at \d+ fails "
                                             "its checksum"):
        with hdf5.File(path, "r") as f:
            f["x"].attrs["note"]


def test_a_flipped_byte_in_a_fletcher32_chunk_is_refused(tmp_path):
    path = tmp_path / "f.h5"
    values = (np.arange(100, dtype=np.uint64) * 2654435761 % 2 ** 32).astype("<u4")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=values, chunks=(50,), fletcher32=True)
    raw = bytearray(path.read_bytes())
    at = raw.index(values[60:62].tobytes())
    raw[at] ^= 0x01
    path.write_bytes(bytes(raw))
    with hdf5.File(path, "r") as f:
        np.testing.assert_array_equal(f["x"][0:50], values[:50])
        with pytest.raises(hdf5.HDF5Error, match="fletcher32 checksum of a chunk of /x"):
            f["x"][()]
    with h5py.File(path, "r") as f, pytest.raises(OSError):
        f["x"][()]


@pytest.mark.parametrize("size", [0, 1, 2, 3, 11, 12, 13, 24, 25, 720, 721, 1441])
def test_checksums_match_libhdf5(size):
    """lookup3 against the reference implementation's known values, and
    Fletcher-32 against a literal transcription of libhdf5's loop."""
    data = bytes(np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8))
    sum1 = sum2 = 0
    words = [data[i] << 8 | data[i + 1] for i in range(0, size - 1, 2)]
    for j in range(0, len(words), 360):
        for w in words[j:j + 360]:
            sum1 += w
            sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if size % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    assert hdf5._fletcher32(data) == (sum2 << 16 | sum1)
    assert hdf5._lookup3(b"") == 0xDEADBEEF
    assert hdf5._lookup3(b"Four score and seven years ago") == 0x17770551


# ------------------------------------------------------------ the netCDF-4 writer of the tests


@pytest.mark.parametrize("chunk_rows,tensor", [(1, False), (7, False), (1, True)],
                         ids=["hourly", "seven_hours", "tensor"])
def test_the_nc4_writer_is_read_alike_by_h5py_and_both_packages(tmp_path, chunk_rows, tensor):
    """A 100-hour slice of two variables (100 chunks each at one hour a
    chunk: a two-level chunk B-tree) in netCDF-C's layout: superblock 2,
    version 2 object headers, shuffle + deflate 4 chunks; h5py reads its
    values, and both packages' ``load_fieldset`` read back the FieldSet."""
    fs = create_mock_era5("2020-01-01", "2020-01-05T03", ["temperature", "u_component_of_wind"],
                          [1000], seed=2)
    fs.attrs.update(variables=["temperature", "u_component_of_wind"], levels=[1000], none=None,
                    nested={"k": [1, 2]})
    values = np.asarray(fs["temperature"].data)
    if tensor:
        f = fs["temperature"]
        fs.data_vars["temperature"] = Field(torch.from_numpy(values.copy()), f.dims, f.coords,
                                            f.attrs, f.name)
    path = tmp_path / "slice.nc"
    info = write_nc4_fieldset(fs, path, chunk_rows=chunk_rows, threads=2)
    n_chunks = -(-values.shape[0] // chunk_rows)
    assert info["chunks"] == 2 * n_chunks and info["raw_bytes"] == 2 * values.nbytes
    raw = path.read_bytes()
    root = int.from_bytes(raw[36:44], "little")
    assert raw[8] == 2 and raw[root:root + 5] == b"OHDR\x02"
    with h5py.File(path, "r") as f:
        t = f["temperature"]
        assert t.chunks == (chunk_rows, *values.shape[1:])
        assert (t.compression, t.compression_opts, t.shuffle) == ("gzip", 4, True)
        np.testing.assert_array_equal(t[()], values)
        assert list(f.keys()) == ["time", "level", "latitude", "longitude", "temperature",
                                  "u_component_of_wind"]
    assert_reads_as_h5py(path)
    assert_fieldset_parity(path)
    back = io_h5.load_fieldset(path)
    np.testing.assert_array_equal(back["temperature"].data, values)
    assert back.attrs["nested"] == {"k": [1, 2]} and back.attrs["none"] is None


def _read_everything(path) -> list:
    """Every key, attribute and dataset value of the file, as the port
    reads them (plain, for comparing)."""
    out, seen = [], set()
    with hdf5.File(path, "r") as f:
        def walk(g):
            out.append((g.name, g.keys(), [(k, _plain_port(f, g.attrs[k])) for k in g.attrs.keys()]))
            for key in g.keys():
                obj = g[key]
                if isinstance(obj, hdf5.Group):
                    if obj._addr not in seen:  # each group once, as h5py visits them
                        seen.add(obj._addr)
                        walk(obj)
                else:
                    out.append((obj.name, [(k, _plain_port(f, obj.attrs[k]))
                                           for k in obj.attrs.keys()], _plain_port(f, obj[()])))
        walk(f)
    return out


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_cut_or_changed_files_raise_or_read_as_before(tmp_path, libver):
    """A file cut short anywhere, or with one byte changed anywhere, either
    raises HDF5Error or reads as h5py reads it: no other exception, and
    no value read that h5py would read differently."""
    path = tmp_path / "f.h5"
    _fieldset_file(path, dict(libver=libver, track_order=True), dict(GZIP, fletcher32=True),
                   n_attrs=12)
    with h5py.File(path, "a") as f:
        for i in range(10):
            f.create_group("g").create_dataset(f"d{i}", data=np.arange(i + 1)) if i == 0 else \
                f["g"].create_dataset(f"d{i}", data=np.arange(i + 1))
    raw = path.read_bytes()
    whole = _read_everything(path)
    rng = np.random.default_rng(7)
    cuts = sorted(set(rng.integers(0, len(raw), 40).tolist()))
    flips = sorted(set(rng.integers(0, len(raw), 120).tolist()))
    for cut in cuts:
        (tmp_path / "cut.h5").write_bytes(raw[:cut])
        with pytest.raises(hdf5.HDF5Error):
            _read_everything(tmp_path / "cut.h5")
    for at in flips:
        changed = bytearray(raw)
        changed[at] ^= 0x5A
        (tmp_path / "bad.h5").write_bytes(bytes(changed))
        try:
            got = _read_everything(tmp_path / "bad.h5")
        except hdf5.HDF5Error:
            continue
        if got != whole:  # a changed value read: h5py must read the same
            assert_reads_as_h5py(tmp_path / "bad.h5")
