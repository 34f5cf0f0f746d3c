"""Two HDF5 files compared as h5py reads them: what a reader can see.

The port writes HDF5 with its own codec and the JAX package through
libhdf5, which places objects at other offsets, so their files of one
FieldSet differ in bytes.  :func:`assert_same_to_a_reader` holds them to
everything else: the same groups and names; each dataset's dtype, shape
and bytes (strings by value); each attribute's name, type (variable- or
fixed-length string with its size and padding, number, reference) and
value, references compared by the names of the objects they point to;
and the dimension scales attached to each axis.
"""

from __future__ import annotations

import h5py
import numpy as np


def _type_of(attr_id) -> tuple:
    t = attr_id.get_type()
    cls = t.get_class()
    if cls == h5py.h5t.STRING:
        if t.is_variable_str():
            return ("variable-length string", t.get_cset())
        return ("fixed string", t.get_size(), t.get_strpad(), t.get_cset())
    if cls == h5py.h5t.VLEN:
        return ("vlen", t.get_super().get_class())
    if cls == h5py.h5t.COMPOUND:
        return ("compound", t.get_size(),
                tuple((t.get_member_name(i), t.get_member_offset(i), t.get_member_class(i))
                      for i in range(t.get_nmembers())))
    if cls == h5py.h5t.REFERENCE:
        return ("reference", t.get_size())
    return ("number", t.dtype.str)


def _plain(f: h5py.File, value):
    """An attribute's value with references replaced by object names."""
    if isinstance(value, h5py.Reference):
        return f[value].name
    if isinstance(value, np.ndarray):
        if value.dtype.names:
            return [tuple(_plain(f, x) for x in row) for row in value.tolist()]
        if value.dtype.kind == "O":
            return [_plain(f, v) for v in value.tolist()]
        return (value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, (list, tuple)):
        return [_plain(f, v) for v in value]
    if isinstance(value, np.generic):
        return (value.dtype.str, value.tobytes())
    return value


def _attrs(f, obj) -> dict:
    out = {}
    for name in obj.attrs:
        attr_id = obj.attrs.get_id(name)
        out[name] = (_type_of(attr_id), attr_id.shape, _plain(f, obj.attrs[name]))
    return out


def _dataset(ds: h5py.Dataset) -> tuple:
    values = ds[()]
    if h5py.check_string_dtype(ds.dtype) is not None:
        info = h5py.check_string_dtype(ds.dtype)
        flat = np.asarray(values, dtype=object).reshape(-1).tolist()
        body = [v.decode() if isinstance(v, bytes) else v for v in flat]
        kind = ("string", info.length, info.encoding)
    else:
        body, kind = np.asarray(values).tobytes(), ds.dtype.str
    scales = [[s.name for s in ds.dims[i].values()] for i in range(ds.ndim)]
    return kind, ds.shape, body, scales


def _tree(f: h5py.File) -> dict:
    out = {"/": ("group", _attrs(f, f))}

    def visit(name, obj):
        if isinstance(obj, h5py.Group):
            out[name] = ("group", _attrs(f, obj))
        else:
            out[name] = ("dataset", _attrs(f, obj), _dataset(obj))

    f.visititems(visit)
    return out


def assert_same_to_a_reader(path_a, path_b) -> None:
    with h5py.File(path_a, "r") as fa, h5py.File(path_b, "r") as fb:
        a, b = _tree(fa), _tree(fb)
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for name in a:
        assert a[name][0] == b[name][0], name
        assert sorted(a[name][1]) == sorted(b[name][1]), (name, sorted(a[name][1]),
                                                          sorted(b[name][1]))
        for attr in a[name][1]:
            assert a[name][1][attr] == b[name][1][attr], (name, attr, a[name][1][attr],
                                                          b[name][1][attr])
        if a[name][0] == "dataset":
            assert a[name][2] == b[name][2], (name, a[name][2][:2], b[name][2][:2])
