"""A FieldSet written as netCDF-C lays out a netCDF-4 file with a
compressed variable, in numpy and the standard library.

The files of this repository's two packages are HDF5 of the oldest
layout (superblock 0, version 1 object headers, symbol-table groups,
contiguous data).  netCDF-C writes another: it tracks creation order, so
its files have a version 2 superblock, version 2 object headers
(``OHDR``, each with its checksum) and new-style groups (link info, group
info and link messages); and with ``zlib=True`` (netCDF4-python's
default deflate level 4, with shuffle) its variables are chunked and
filtered.  :func:`write_nc4_fieldset` writes that layout:

- superblock version 2 (libver bounds earliest to v1.8, as netCDF-C sets
  them), its checksum;
- every object header of version 2, attribute creation order tracked and
  indexed, each attribute a compact version 1 message, an attribute info
  message beside them;
- the root group's links as compact link messages with their creation
  order, a link info and a group info message;
- coordinate variables contiguous, dimension scales with ``CLASS``,
  ``NAME``, ``_Netcdf4Dimid``, ``DIMENSION_LIST`` and ``REFERENCE_LIST``
  (variable-length data in a global heap), times as CF int64;
- data variables chunked ``chunk_rows`` rows at a time (one hour of a
  (time, level, latitude, longitude) field a chunk by default: 4.15 MB
  at 0.25 degrees, near netCDF-C's default chunk target of 4 MiB), each
  chunk shuffled and deflated (a version 1 filter pipeline: shuffle,
  deflate), indexed by a version 1 B-tree of type 1 (K 32, libhdf5's
  default for chunk B-trees).

The FieldSet's attributes and names follow ``utils/io_h5.save_fieldset``
(``dims``, CF ``coordinates``, hidden dimension scales), so that either
package's ``load_fieldset`` reads back the FieldSet.  Chunks are
compressed in a pool of threads (zlib releases the GIL).  This is a test
helper: the package reads such files and never writes them.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from dmd_era5_tpu_torch.utils import hdf5, io_h5

_UNDEF = hdf5._UNDEF
_CHUNK_K = 32  # libhdf5's default K of a chunk B-tree: nodes of at most 64 entries
_NC_PROPERTIES = "version=2,netcdf=4.9.2,hdf5=1.14.6"


class _Obj:
    """A group or a dataset being written: its name, attributes (in
    creation order) and, for a dataset, type, shape and storage."""

    def __init__(self, name: str, kind: str):
        self.name, self.kind = name, kind
        self.attrs: dict[str, tuple] = {}
        self.links: dict[str, _Obj] = {}
        self.type = self.shape = None
        self.data_addr = _UNDEF  # contiguous data
        self.chunks: list[tuple] | None = None  # (row offset, stored bytes, address)
        self.chunk = None
        self._waddr = 0  # its object header's address (the global heap's name for it)

    def set_attr(self, name: str, value) -> None:
        self.attrs[name] = hdf5._encode_value(value)


class _Writer:
    def __init__(self, path, threads: int):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.fd = os.open(self.path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        self.end = 48  # the superblock's bytes come first
        self.threads = threads
        self.root = _Obj("/", "group")

    def allocate(self, n: int) -> int:
        addr = self.end
        self.end = hdf5._align8(self.end + n)
        return addr

    def pwrite(self, addr: int, data) -> None:
        view = memoryview(data).cast("B")
        done = 0
        while done < view.nbytes:
            done += os.pwrite(self.fd, view[done:done + (1 << 30)], addr + done)

    def dataset(self, name: str, values: np.ndarray | None, shape=None, dtype=None) -> _Obj:
        ds = _Obj(f"/{name}", "dataset")
        if values is None:  # never written: reads as the fill, zeros
            ds.type, ds.shape = hdf5._type_of_dtype(np.dtype(dtype)), tuple(shape)
        else:
            ds.type, ds.shape, payload, _ = hdf5._encode_value(values)
            if ds.type.kind == "vstr":
                ds.strings = payload
            elif math.prod(ds.shape):
                ds.data_addr = self.allocate(len(payload.tobytes()))
                self.pwrite(ds.data_addr, payload)
        self.root.links[name] = ds
        return ds

    def compressed(self, name: str, data, chunk_rows: int, level: int) -> _Obj:
        """A dataset of ``data`` (numpy, or a tensor read to the host a
        chunk at a time) in chunks of ``chunk_rows`` rows, each shuffled
        and deflated at ``level`` in the pool."""
        ds = _Obj(f"/{name}", "dataset")
        dtype = np.dtype(str(data.dtype).replace("torch.", "")) if not isinstance(
            data, np.ndarray) else data.dtype
        ds.type, ds.shape = hdf5._type_of_dtype(dtype), tuple(int(n) for n in data.shape)
        ds.chunk = (chunk_rows, *ds.shape[1:])
        size = ds.type.size

        def encode(r0: int) -> bytes:
            rows = data[r0:r0 + chunk_rows]
            rows = np.ascontiguousarray(rows if isinstance(rows, np.ndarray)
                                        else rows.contiguous().cpu().numpy(), dtype.newbyteorder("<"))
            block = np.zeros((chunk_rows, *ds.shape[1:]), rows.dtype)  # a ragged last chunk's pad
            block[:len(rows)] = rows
            planes = block.reshape(-1).view(np.uint8).reshape(-1, size).T  # shuffle
            return zlib.compress(np.ascontiguousarray(planes).tobytes(), level)

        ds.chunks = []
        with ThreadPoolExecutor(self.threads) as pool:
            for r0, raw in zip(range(0, ds.shape[0], chunk_rows),
                               pool.map(encode, range(0, ds.shape[0], chunk_rows))):
                addr = self.allocate(len(raw))
                self.pwrite(addr, raw)
                ds.chunks.append((r0, len(raw), addr))
        self.root.links[name] = ds
        return ds

    # ---- the metadata, laid out when the file is closed

    def close(self) -> None:
        objects = [self.root] + list(self.root.links.values())
        heap, vlen = hdf5._Heap(), {}
        for obj in objects:
            for name, (t, _, payload, _) in obj.attrs.items():
                if t.kind == "vstr":
                    vlen[id(obj), name] = heap.strings(payload)
                elif t.kind == "vref":
                    vlen[id(obj), name] = heap.sequences(payload)
            if obj.kind == "dataset" and obj.type.kind == "vstr":
                vlen[id(obj), None] = heap.strings(obj.strings)
        heap.place(self.allocate)
        for obj in objects:
            if obj.kind == "dataset" and obj.type.kind == "vstr" and math.prod(obj.shape):
                obj.data_addr = self.allocate(16 * math.prod(obj.shape))
        btrees = {id(o): self._btree_nodes(o) for o in objects if o.chunks is not None}
        sizes = [len(self._header(obj, heap, vlen)) for obj in objects]  # addresses 0 for now
        for obj, size in zip(objects, sizes):
            obj._waddr = self.allocate(size)
        for obj in objects:
            if obj.chunks is not None:
                obj.btree = self._place_btree(obj, btrees[id(obj)])
        heap.write(self.pwrite)
        for obj, size in zip(objects, sizes):
            if obj.kind == "dataset" and obj.type.kind == "vstr" and obj.data_addr != _UNDEF:
                self.pwrite(obj.data_addr, heap.elements(*vlen[id(obj), None]))
            raw = self._header(obj, heap, vlen)
            assert len(raw) == size
            self.pwrite(obj._waddr, raw)
            if obj.chunks is not None:
                self._write_btree(obj, btrees[id(obj)])
        sb = struct.pack("<8sBBBB4Q", hdf5._SIGNATURE, 2, 8, 8, 0, 0, _UNDEF, self.end,
                         self.root._waddr)
        self.pwrite(0, sb + struct.pack("<I", hdf5._lookup3(sb)))
        os.ftruncate(self.fd, self.end)
        os.close(self.fd)

    def _attribute(self, obj, name, t, shape, payload, heap, vlen) -> bytes:
        if t.kind in ("vstr", "vref"):
            data = heap.elements(*vlen[id(obj), name])
        elif t.kind == "reflist":
            rec = np.zeros(len(payload), [("r", "<u8"), ("d", "<i4"), ("pad", "<i4")])
            rec["r"] = [o._waddr for o, _ in payload]
            rec["d"] = [axis for _, axis in payload]
            data = rec.tobytes()
        else:
            data = bytes(payload) if isinstance(payload, bytes) else payload.tobytes()
        raw_name, dt, ds = name.encode() + b"\0", hdf5._type_bytes(t), hdf5._space_bytes(shape)
        return (struct.pack("<BxHHH", 1, len(raw_name), len(dt), len(ds)) + hdf5._padded(raw_name)
                + hdf5._padded(dt) + hdf5._padded(ds) + data)

    def _header(self, obj: _Obj, heap, vlen) -> bytes:
        """The version 2 object header of ``obj``: attribute creation order
        tracked and indexed, 6-byte message headers, its checksum."""
        msgs = []
        if obj.kind == "group":
            msgs.append((0x02, struct.pack("<BBQQQQ", 0, 3, len(obj.links), _UNDEF, _UNDEF,
                                           _UNDEF)))
            msgs.append((0x0A, bytes(2)))
            for order, (name, child) in enumerate(obj.links.items()):
                raw = name.encode()
                msgs.append((0x06, struct.pack("<BBQB", 1, 0x04, order, len(raw)) + raw
                             + struct.pack("<Q", child._waddr)))
        else:
            t, shape = obj.type, obj.shape
            msgs.append((0x01, hdf5._space_bytes(shape)))
            msgs.append((0x03, hdf5._type_bytes(t)))
            msgs.append((0x05, struct.pack("<BBBBI", 2, 2 if obj.chunks is None else 3, 2, 1, 0)))
            if obj.chunks is None:
                size = math.prod(shape) * t.size
                msgs.append((0x08, struct.pack("<BBQQ", 3, 1, obj.data_addr, size)))
            else:
                dims = (*obj.chunk, t.size)
                msgs.append((0x08, struct.pack(f"<BBBQ{len(dims)}I", 3, 2, len(dims),
                                               getattr(obj, "btree", 0), *dims)))
                # shuffle (its element size), deflate (its level): each optional
                msgs.append((0x0B, struct.pack("<BB6x", 1, 2)
                             + struct.pack("<HHHHII", 2, 0, 1, 1, t.size, 0)
                             + struct.pack("<HHHHII", 1, 0, 1, 1, obj.level, 0)))
        msgs.append((0x15, struct.pack("<BBHQQQ", 0, 3, len(obj.attrs), _UNDEF, _UNDEF, _UNDEF)))
        for name, (t, shape, payload, _) in obj.attrs.items():
            msgs.append((0x0C, self._attribute(obj, name, t, shape, payload, heap, vlen)))
        body, n_attrs = b"", 0
        for mtype, raw in msgs:  # an attribute's creation order in its message's header
            body += struct.pack("<BHBH", mtype, len(raw), 0, n_attrs if mtype == 0x0C else 0) + raw
            n_attrs += mtype == 0x0C
        head = b"OHDR" + bytes([2, 0x04 | 0x08 | 0x02]) + struct.pack("<I", len(body))
        return head + body + struct.pack("<I", hdf5._lookup3(head + body))

    # ---- the chunk index: a version 1 B-tree of type 1

    def _key(self, obj: _Obj, r0: int, nbytes: int, right: bool = False) -> bytes:
        rank = len(obj.shape)
        offsets = [r0] + [0] * (rank - 1) + [0]
        if right:  # the key right of the last chunk: one chunk on in every dimension
            offsets = [o + c for o, c in zip(offsets, (*obj.chunk, obj.type.size))]
        return struct.pack(f"<II{rank + 1}Q", nbytes, 0, *offsets)

    def _btree_nodes(self, obj: _Obj) -> list[list[list]]:
        """The tree's levels, leaves first: each level a list of nodes,
        each node a list of its children (chunks, or nodes below)."""
        per = 2 * _CHUNK_K
        level = [obj.chunks[i:i + per] for i in range(0, len(obj.chunks), per)] or [[]]
        levels = [level]
        while len(levels[-1]) > 1:
            below = levels[-1]
            levels.append([list(range(i, min(i + per, len(below))))
                           for i in range(0, len(below), per)])
        return levels

    def _node_size(self, obj: _Obj) -> int:
        key = 8 + 8 * (len(obj.shape) + 1)
        return 24 + 2 * _CHUNK_K * (key + 8) + key

    def _place_btree(self, obj: _Obj, levels) -> int:
        """Each node's address, put first in its list; the root's."""
        for level in levels:
            for node in level:
                node.insert(0, self.allocate(self._node_size(obj)))
        return levels[-1][0][0]

    def _write_btree(self, obj: _Obj, levels) -> None:
        last = obj.chunks[-1]
        right = self._key(obj, last[0], 0, right=True)

        def first_key(depth: int, node) -> bytes:
            while depth:
                node, depth = levels[depth - 1][node[1]], depth - 1
            r0, nbytes, _ = node[1]
            return self._key(obj, r0, nbytes)

        for depth, level in enumerate(levels):
            for j, node in enumerate(level):
                addr, children = node[0], node[1:]
                left = level[j - 1][0] if j else _UNDEF
                right_sib = level[j + 1][0] if j + 1 < len(level) else _UNDEF
                raw = struct.pack("<4sBBHQQ", b"TREE", 1, depth, len(children), left, right_sib)
                for child in children:
                    if depth:
                        below = levels[depth - 1][child]
                        raw += first_key(depth - 1, below) + struct.pack("<Q", below[0])
                    else:
                        raw += self._key(obj, child[0], child[1]) + struct.pack("<Q", child[2])
                raw += first_key(depth, level[j + 1]) if j + 1 < len(level) else right
                self.pwrite(addr, raw.ljust(self._node_size(obj), b"\0"))


def write_nc4_fieldset(fs, path, chunk_rows: int = 1, level: int = 4,
                       threads: int = 8) -> dict:
    """``fs`` (a FieldSet of the port, its data numpy arrays or tensors)
    written to ``path`` in netCDF-C's layout (see the module's
    docstring); returns the file's bytes, the data variables' raw and
    compressed bytes and their chunks."""
    w = _Writer(path, threads)
    f = w.root
    f.set_attr("_NCProperties", hdf5._Fixed(_NC_PROPERTIES.encode() + b"\0", 0))
    for key, value in fs.attrs.items():
        f.set_attr(key, io_h5._encode_attr(value))
    coords, dim_sizes = {}, {}
    for field in fs.data_vars.values():
        for cname, coord in field.coords.items():
            coords.setdefault(cname, coord)
        dim_sizes.update(zip(field.dims, field.shape))
    for coord in coords.values():
        for d, n in zip(coord.dims, coord.values.shape):
            dim_sizes.setdefault(d, n)
    scales = {}

    def scale(ds: _Obj, name: str) -> None:
        ds.set_attr("CLASS", hdf5._Fixed(b"DIMENSION_SCALE\0", 0))
        ds.set_attr("NAME", hdf5._Fixed(name.encode() + b"\0", 0))
        ds.set_attr("_Netcdf4Dimid", np.int32(len(scales)))
        scales[name] = ds

    def attach(ds: _Obj, dims) -> None:
        ds.attrs["DIMENSION_LIST"] = (hdf5._VREF, (len(dims),), [[scales[d]] for d in dims], None)
        for axis, d in enumerate(dims):
            back = scales[d].attrs.get("REFERENCE_LIST")
            entries = (list(back[2]) if back else []) + [(ds, axis)]
            scales[d].attrs["REFERENCE_LIST"] = (hdf5._REFLIST, (len(entries),), entries, None)

    def dataset(name, values, dims) -> _Obj:
        arr, meta = io_h5._encode_array(np.asarray(values))
        ds = w.dataset(name, arr)
        ds.set_attr("dims", io_h5._str_list_attr(dims))
        for k, v in meta.items():
            ds.set_attr(k, v)
        return ds

    for cname, coord in coords.items():
        if tuple(coord.dims) == (cname,):
            scale(dataset(cname, coord.values, coord.dims), cname)
    for d, n in dim_sizes.items():
        if d not in f.links:
            ds = w.dataset(d, None, shape=(n,), dtype="f4")
            scale(ds, d)
            ds.set_attr("NAME", np.bytes_((io_h5._NC_HIDDEN_DIM + "%10d") % n))
    aux = [c for c, coord in coords.items() if tuple(coord.dims) != (c,)]
    for cname in aux:
        attach(dataset(cname, coords[cname].values, coords[cname].dims), coords[cname].dims)
    raw_bytes = 0
    for name, field in fs.data_vars.items():
        ds = w.compressed(name, field.data, chunk_rows, level)
        ds.level = level
        raw_bytes += math.prod(ds.shape) * ds.type.size
        ds.set_attr("dims", io_h5._str_list_attr(field.dims))
        attach(ds, field.dims)
        if [c for c in field.coords if c in aux]:
            ds.set_attr("coordinates", " ".join(c for c in field.coords if c in aux))
        for k, v in field.attrs.items():
            ds.set_attr(k, io_h5._encode_attr(v))
    compressed = sum(n for o in f.links.values() if o.chunks for _, n, _ in o.chunks)
    n_chunks = sum(len(o.chunks) for o in f.links.values() if o.chunks)
    w.close()
    return {"bytes": Path(path).stat().st_size, "raw_bytes": raw_bytes,
            "compressed_bytes": compressed, "chunks": n_chunks}
