"""The port's HDF5 codec (``dmd_era5_tpu_torch/utils/hdf5.py``) held to h5py.

Every case runs both ways in one process: the port writes and h5py reads
the same values and types; h5py writes (as the JAX package does, at its
default ``libver='earliest'``) and the port reads them bit for bit.  The
cases: every datatype of the subset, scalar and 0-length datasets, nested
groups, more entries than one symbol-table node holds by default,
attributes that need a continuation block, chunked datasets with ragged
last chunks, dimension scales; then the refusals: a superblock of
version 3 (``libver='latest'``), deflate, version 2 object headers, a truncated
file, a foreign one.
"""

from __future__ import annotations

import zlib

import h5py
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from dmd_era5_tpu_torch.pipeline.artifacts import file_md5
from dmd_era5_tpu_torch.utils import hdf5

NUMBERS = ["i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f4", "f8"]
TYPES = NUMBERS + ["bool", "c8", "c16"]
# h5py stores str as C strings: no NUL; surrogates are not UTF-8
TEXT = st.text(st.characters(blacklist_categories=("Cs",), blacklist_characters="\0"),
               max_size=40)


def _values(dtype: str, shape) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(f"{dtype} {shape}".encode()))
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(shape) < 0.5
    if dt.kind == "c":
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dt)
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ------------------------------------------------------------ numbers


@pytest.mark.parametrize("shape", [(), (0,), (5,), (3, 4, 2)], ids=["scalar", "empty", "1d", "3d"])
@pytest.mark.parametrize("dtype", TYPES)
def test_numbers_cross_both_ways(tmp_path, dtype, shape):
    values = _values(dtype, shape)
    with hdf5.File(tmp_path / "port.h5", "w") as f:
        f.create_dataset("v", data=values)
        f.attrs["a"] = values
    with h5py.File(tmp_path / "port.h5", "r") as f:
        assert _same(f["v"][()], values) and _same(f.attrs["a"], values)
        assert f["v"].dtype == values.dtype
    with h5py.File(tmp_path / "h5py.h5", "w") as f:
        f.create_dataset("v", data=values)
        f.attrs["a"] = values
    with hdf5.File(tmp_path / "h5py.h5", "r") as f:
        assert f["v"].shape == shape and f["v"].dtype == values.dtype
        assert _same(f["v"][()], values) and _same(f.attrs["a"], values)


@settings(max_examples=30, deadline=None, database=None)
@given(hnp.arrays(st.sampled_from([np.dtype(t) for t in TYPES]),
                  hnp.array_shapes(min_dims=1, max_dims=3, min_side=0, max_side=6)))
def test_drawn_arrays_cross_both_ways(tmp_path_factory, values):
    tmp = tmp_path_factory.mktemp("drawn")
    with hdf5.File(tmp / "port.h5", "w") as f:
        f.create_dataset("v", data=values)
    with h5py.File(tmp / "port.h5", "r") as f:
        assert _same(f["v"][()], values)
    with h5py.File(tmp / "h5py.h5", "w") as f:
        f.create_dataset("v", data=values)
    with hdf5.File(tmp / "h5py.h5", "r") as f:
        assert _same(f["v"][()], values)


def test_python_scalars_take_h5py_types(tmp_path):
    """int -> int64, float -> f8, bool -> h5py's bool, str -> a
    variable-length UTF-8 string, bytes -> a variable-length ASCII one,
    np.bytes_ -> a fixed-length one, as h5py types them."""
    scalars = {"i": 7, "f": 0.25, "b": True, "s": "héllo", "e": "", "x": np.bytes_(b"fixed"),
               "a": b"ascii"}
    for writer in ("port", "h5py"):
        path = tmp_path / f"{writer}.h5"
        with (hdf5.File(path, "w") if writer == "port" else h5py.File(path, "w")) as f:
            for name, value in scalars.items():
                f.attrs[name] = value
        with h5py.File(path, "r") as f:
            types = {name: f.attrs.get_id(name).get_type() for name in scalars}
            assert types["i"].dtype == np.int64 and types["f"].dtype == np.float64
            assert f.attrs["b"] == np.True_ and f.attrs["s"] == "héllo" and f.attrs["e"] == ""
            assert h5py.check_string_dtype(types["s"].dtype).length is None
            assert f.attrs["x"] == b"fixed" and types["x"].get_size() == 5
            assert f.attrs["a"] == "ascii" and types["a"].get_cset() == h5py.h5t.CSET_ASCII
            assert h5py.check_string_dtype(types["a"].dtype).length is None
        with hdf5.File(path, "r") as f:
            assert dict(f.attrs.items()) == {"a": "ascii", "b": True, "e": "", "f": 0.25, "i": 7,
                                             "s": "héllo", "x": "fixed"}
            assert type(f.attrs["i"]) is np.int64 and type(f.attrs["s"]) is str


# ------------------------------------------------------------ strings


@settings(max_examples=30, deadline=None, database=None)
@given(st.lists(TEXT, max_size=12), TEXT)
def test_variable_length_strings_cross_both_ways(tmp_path_factory, strings, scalar):
    tmp = tmp_path_factory.mktemp("strings")
    arr = np.empty(len(strings), object)
    arr[:] = strings
    with hdf5.File(tmp / "port.h5", "w") as f:
        f.create_dataset("v", data=arr)
        f.attrs["list"] = arr
        f.attrs["one"] = scalar
    with h5py.File(tmp / "port.h5", "r") as f:
        assert [s.decode() for s in f["v"][()]] == strings
        assert list(f.attrs["list"]) == strings and f.attrs["one"] == scalar
    with h5py.File(tmp / "h5py.h5", "w") as f:
        f.create_dataset("v", data=np.asarray(strings, dtype=h5py.string_dtype()))
        f.attrs["list"] = np.asarray(strings, dtype=h5py.string_dtype())
        f.attrs["one"] = scalar
    with hdf5.File(tmp / "h5py.h5", "r") as f:
        assert f["v"][()].tolist() == strings and f.attrs["list"].tolist() == strings
        assert f.attrs["one"] == scalar


def test_repeated_strings_share_heap_objects(tmp_path):
    """A long coordinate of few distinct strings (``original_variable``
    over space) is written as one heap object a distinct string and read
    back element for element, by h5py too."""
    names = np.repeat(np.asarray(["temperature", "u_component_of_wind", "temperature"], object),
                      [5000, 3000, 2000])
    with hdf5.File(tmp_path / "p.h5", "w") as f:
        f.create_dataset("original_variable", data=names)
    with hdf5.File(tmp_path / "p.h5", "r") as f:
        assert f["original_variable"][()].tolist() == names.tolist()
    with h5py.File(tmp_path / "p.h5", "r") as f:
        assert f["original_variable"].asstr()[()].tolist() == names.tolist()
    assert (tmp_path / "p.h5").stat().st_size < 10_000 * 16 + 8192


def test_fixed_length_strings_of_both_paddings(tmp_path):
    """NULLPAD (h5py's bytes) and NULLTERM (the dimension scales' CLASS)
    fixed-length strings, written by h5py and read as str."""
    with h5py.File(tmp_path / "h.h5", "w") as f:
        f.attrs["pad"] = np.bytes_(b"abc")
        tid = h5py.h5t.C_S1.copy()
        tid.set_size(8)
        tid.set_strpad(h5py.h5t.STR_NULLTERM)
        attr = h5py.h5a.create(f.id, b"term", tid, h5py.h5s.create(h5py.h5s.SCALAR))
        attr.write(np.array(b"xy\0junk", dtype="S8"))
        f.create_dataset("arr", data=np.asarray([b"a", b"bcd"], dtype="S3"))
    with hdf5.File(tmp_path / "h.h5", "r") as f:
        assert f.attrs["pad"] == "abc" and f.attrs["term"] == "xy"
        assert f["arr"][()].tolist() == ["a", "bcd"]


# ------------------------------------------------------------ groups


@pytest.mark.parametrize("writer", ["port", "h5py"])
def test_nested_groups_and_many_entries(tmp_path, writer):
    """The legacy /vars + /coords layout (nested groups) and a group of
    40 entries (more than a symbol-table node's 8 by default: h5py splits
    it over nodes, the port raises the leaf K)."""
    path = tmp_path / "g.h5"
    data = {f"d{i:02d}": np.arange(i, dtype=np.int32) for i in range(40)}
    with (hdf5.File(path, "w") if writer == "port" else h5py.File(path, "w")) as f:
        for name, value in data.items():
            f.create_dataset(name, data=value)
        inner = f.create_group("vars").create_group("deeper")
        inner.create_dataset("x", data=np.ones((2, 3), np.float32))
        inner.attrs["note"] = "legacy"
        f.create_group("coords")
    for reader in (hdf5.File, h5py.File):
        with reader(path, "r") as f:
            assert sorted(f.keys()) == sorted([*data, "coords", "vars"])
            for name, value in data.items():
                assert _same(f[name][()], value)
            assert _same(f["vars/deeper/x"][()], np.ones((2, 3), np.float32))
            assert f["vars"]["deeper"].attrs["note"] == "legacy"
            assert len(f["coords"]) == 0


def test_attributes_past_a_continuation_block(tmp_path):
    """h5py's object header overflows into continuation blocks once its
    attributes outgrow the first block: the port follows them."""
    attrs = {f"attr_{i:02d}": np.arange(100, dtype=np.float64) + i for i in range(30)}
    with h5py.File(tmp_path / "h.h5", "w") as f:
        ds = f.create_dataset("x", data=np.zeros(3))
        for name, value in attrs.items():
            ds.attrs[name] = value
    raw = (tmp_path / "h.h5").read_bytes()
    with hdf5.File(tmp_path / "h.h5", "r") as f:
        addr = f["x"]._addr
        first_block = int.from_bytes(raw[addr + 8:addr + 12], "little")
        assert first_block < 30 * 800  # the attributes do not fit the first block
        assert sorted(f["x"].attrs.keys()) == sorted(attrs)
        for name, value in attrs.items():
            assert _same(f["x"].attrs[name], value)


# ------------------------------------------------------------ chunked data


@pytest.mark.parametrize("chunks", [(7, 12), (7, 5), (30, 4), (1, 12)])
@pytest.mark.parametrize("dtype", ["f4", "u2"])
def test_chunked_datasets_with_ragged_last_chunks(tmp_path, chunks, dtype):
    """A (30, 12) dataset in chunks that do not divide it: whole reads,
    row slices, and read_direct into a caller's buffer, bit for bit."""
    values = _values(dtype, (30, 12))
    with h5py.File(tmp_path / "c.h5", "w") as f:
        f.create_dataset("X", data=values, chunks=chunks)
    with hdf5.File(tmp_path / "c.h5", "r") as f:
        ds = f["X"]
        assert ds.shape == (30, 12) and _same(ds[()], values)
        for r0, r1 in ((0, 30), (3, 11), (6, 8), (29, 30), (10, 10)):
            assert _same(ds[r0:r1], values[r0:r1]) and _same(ds[r0:r1, :], values[r0:r1])
            dest = np.empty((r1 - r0, 12), dtype)
            ds.read_direct(dest, np.s_[r0:r1, :])
            assert _same(dest, values[r0:r1])


def test_unwritten_data_reads_as_the_fill(tmp_path):
    """A dataset created and never written has no storage: zeros, as
    libhdf5 gives its default fill; so do unallocated chunks."""
    with h5py.File(tmp_path / "h.h5", "w") as f:
        f.create_dataset("late", shape=(4,), dtype="f4")
        c = f.create_dataset("chunked", shape=(10, 3), dtype="i4", chunks=(4, 3))
        c[0:4] = 1
    with hdf5.File(tmp_path / "p.h5", "w") as f:
        f.create_dataset("late", shape=(4,), dtype="f4")
    for path in (tmp_path / "h.h5", tmp_path / "p.h5"):
        with hdf5.File(path, "r") as f:
            assert _same(f["late"][()], np.zeros(4, np.float32))
    with h5py.File(tmp_path / "p.h5", "r") as f:
        assert _same(f["late"][()], np.zeros(4, np.float32))
    with hdf5.File(tmp_path / "h.h5", "r") as f:
        want = np.zeros((10, 3), np.int32)
        want[:4] = 1
        assert _same(f["chunked"][()], want)


def test_slabs_of_rows_and_blocks(tmp_path):
    """Row slabs go straight to their offset, column blocks through a
    memory map; a reader sees the array they make."""
    values = _values("f4", (50, 9))
    with hdf5.File(tmp_path / "p.h5", "w") as f:
        rows = f.create_dataset("rows", shape=values.shape, dtype="f4")
        for r0 in range(0, 50, 16):
            rows[r0:r0 + 16] = values[r0:r0 + 16]
        blocks = f.create_dataset("blocks", shape=values.shape, dtype="f4")
        for c0 in range(0, 9, 4):
            blocks[0:30, c0:c0 + 4] = values[0:30, c0:c0 + 4]
            blocks[30:50, c0:c0 + 4] = values[30:50, c0:c0 + 4]
        with pytest.raises(ValueError):
            rows[0:2] = values[:3]
    for reader in (hdf5.File, h5py.File):
        with reader(tmp_path / "p.h5", "r") as f:
            assert _same(f["rows"][()], values) and _same(f["blocks"][()], values)


# ------------------------------------------------------------ dimension scales


def test_dimension_scales_both_ways(tmp_path):
    """Scales made and attached by h5py (H5DS) are read by the port as
    each axis's scale names; the port's are h5py's dimension scales."""
    for writer in ("port", "h5py"):
        path = tmp_path / f"{writer}.h5"
        with (hdf5.File(path, "w") if writer == "port" else h5py.File(path, "w")) as f:
            t = f.create_dataset("time", data=np.arange(3, dtype=np.int64))
            t.make_scale("time")
            s = f.create_dataset("space", data=np.arange(4, dtype=np.int64))
            s.make_scale("space")
            x = f.create_dataset("X", data=np.zeros((4, 3), np.float32))
            y = f.create_dataset("Y", data=np.zeros((4,), np.float32))
            if writer == "port":
                x.attach_scale(0, s)
                x.attach_scale(1, t)
                y.attach_scale(0, s)
            else:
                x.dims[0].attach_scale(s)
                x.dims[1].attach_scale(t)
                y.dims[0].attach_scale(s)
        with h5py.File(path, "r") as f:
            assert f["X"].dims[0][0] == f["space"] and f["X"].dims[1][0] == f["time"]
            assert h5py.h5ds.is_scale(f["time"].id) and f["time"].attrs["CLASS"] == b"DIMENSION_SCALE"
            assert h5py.h5ds.is_attached(f["X"].id, f["space"].id, 0)
            assert h5py.h5ds.is_attached(f["Y"].id, f["space"].id, 0)
            assert [f[r].name for r, _ in f["space"].attrs["REFERENCE_LIST"]] == ["/X", "/Y"]
        with hdf5.File(path, "r") as f:
            assert f["X"].scales() == (("/space",), ("/time",)) and f["Y"].scales() == (("/space",),)
            assert f["time"].attrs["CLASS"] == "DIMENSION_SCALE" and f["time"].attrs["NAME"] == "time"
            refs = f["space"].attrs["REFERENCE_LIST"]
            assert [(f._path_of(r), axis) for r, axis in refs] == [("/X", 0), ("/Y", 0)]


# ------------------------------------------------------------ bytes


def test_one_input_gives_one_file(tmp_path):
    """The same calls give the same bytes (the store is content-addressed)."""
    def write(path):
        with hdf5.File(path, "w") as f:
            f.attrs["names"] = np.asarray(["a", "b"], object)
            t = f.create_dataset("t", data=np.arange(5))
            t.make_scale("t")
            x = f.create_dataset("x", shape=(5, 2), dtype="f8")
            x[0:5] = np.ones((5, 2))
            x.attach_scale(0, t)
            f.create_group("g").create_dataset("s", data=np.asarray(["q"] * 3, object))

    write(tmp_path / "a.h5")
    write(tmp_path / "b.h5")
    assert file_md5(tmp_path / "a.h5") == file_md5(tmp_path / "b.h5")


# ------------------------------------------------------------ refusals


def test_superblock_of_a_later_version_is_refused(tmp_path):
    with h5py.File(tmp_path / "late.h5", "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3))
    with pytest.raises(hdf5.HDF5Error, match="superblock version 3"):
        hdf5.File(tmp_path / "late.h5", "r")


@pytest.mark.parametrize("filters", [{"compression": "gzip"}, {"shuffle": True}],
                         ids=["deflate", "shuffle"])
def test_filters_are_refused_by_name(tmp_path, filters):
    with h5py.File(tmp_path / "z.h5", "w") as f:
        f.create_dataset("x", data=np.arange(100.0), chunks=(10,), **filters)
    name = "deflate" if "compression" in filters else "shuffle"
    with hdf5.File(tmp_path / "z.h5", "r") as f, pytest.raises(hdf5.HDF5Error, match=name):
        f["x"][()]


def test_version_2_object_headers_are_refused_by_name(tmp_path):
    """h5py's ``track_order`` groups take version 2 object headers."""
    with h5py.File(tmp_path / "o.h5", "w", track_order=True) as f:
        f.create_dataset("x", data=np.arange(3))
    with pytest.raises(hdf5.HDF5Error, match=r"version 2 object header \(OHDR\)"):
        with hdf5.File(tmp_path / "o.h5", "r") as f:
            f.keys()


def test_truncated_and_foreign_files_are_refused(tmp_path):
    with h5py.File(tmp_path / "x.h5", "w") as f:
        f.create_dataset("x", data=np.arange(1000.0))
    raw = (tmp_path / "x.h5").read_bytes()
    (tmp_path / "cut.h5").write_bytes(raw[: len(raw) // 2])
    with pytest.raises(hdf5.HDF5Error):
        with hdf5.File(tmp_path / "cut.h5", "r") as f:
            f["x"][()]
    (tmp_path / "foreign.h5").write_bytes(b"CDF\x01" + bytes(200))
    with pytest.raises(hdf5.HDF5Error, match="not an HDF5 file"):
        hdf5.File(tmp_path / "foreign.h5", "r")
    with pytest.raises(OSError):
        hdf5.File(tmp_path / "missing.h5", "r")


def test_datatypes_outside_the_subset_are_refused_by_name(tmp_path):
    with h5py.File(tmp_path / "t.h5", "w") as f:
        f.create_dataset("half", data=np.arange(3, dtype=np.float16))
        f.create_dataset("rec", data=np.zeros(2, [("a", "i4"), ("b", "f8")]))
        f.create_dataset("opaque", data=np.void(b"\x01\x02"))
        f.create_dataset("enum", data=np.arange(2, dtype="u1"),
                         dtype=h5py.enum_dtype({"RED": 0, "GREEN": 1}, basetype="u1"))
    with hdf5.File(tmp_path / "t.h5", "r") as f:
        for name, what in (("half", "floating-point"), ("rec", "compound"), ("opaque", "opaque"),
                           ("enum", "enum")):
            with pytest.raises(hdf5.HDF5Error, match=what):
                f[name][()]
