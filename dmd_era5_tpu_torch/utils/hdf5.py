"""HDF5 files in numpy and the standard library.

The port reads and writes the subset of the HDF5 file format that the
package's own files use, as h5py 3 (libhdf5 1.14, ``libver='earliest'``)
writes them, with no HDF5 library underneath.  The structures are those
of the *HDF5 File Format Specification*:

- superblock version 0 (version 1 is read too), 8-byte offsets and lengths;
- version 1 object headers, with continuation blocks;
- groups as symbol tables (a version 1 B-tree of type 0, a local heap,
  symbol-table nodes), nested to any depth;
- scalar and simple dataspaces;
- datatypes: fixed-point (1, 2, 4, 8 bytes), IEEE floating-point (4, 8
  bytes), h5py's bool (an int8 enum FALSE/TRUE), h5py's complex (a
  compound of ``r`` and ``i``), fixed-length strings (NULLTERM, NULLPAD),
  variable-length strings through global-heap collections, object
  references, and the two types of dimension scales: ``DIMENSION_LIST``
  (a variable-length sequence of object references) and
  ``REFERENCE_LIST`` (a compound of a reference and an int32);
- compact attributes;
- contiguous data, and chunked data indexed by a version 1 B-tree of
  type 1 without filters.

Anything else is refused with an :class:`HDF5Error` (an ``OSError``) that
names the structure: a superblock of version 2 or later, a version 2
object header, dense attribute or link storage, a filter pipeline such as
deflate, a datatype outside the list above.  A truncated or foreign file
raises the same error; nothing here returns a value it could not read.

The writer writes the same subset.  A dataset's data is contiguous, at
one offset reserved when it is first written (a slab of rows goes there
at once, ``ds[r0:r1] = rows``); the metadata (object headers, heaps,
B-trees, the global heap) is laid out when the file is closed.  Equal
strings of one file share one global-heap object, and every group's
entries fit in one symbol-table node (the superblock's group leaf K is
set for it).  One sequence of calls gives one file, byte for byte.

Strings come back as ``str``: a scalar as ``str``, an array as an object
array of ``str``.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Any, Iterator, NamedTuple

import numpy as np

__all__ = ["HDF5Error", "File", "Group", "Dataset", "Reference"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_IO_BYTES = 1 << 30  # the most bytes one read or write system call is given
_HEAP_MIN = 4096  # a global-heap collection's least size (libhdf5 reads that much first)
_FREE_NULL = 1  # a local heap's "no free block" offset
_INTERNAL_K = 16  # group B-tree internal node K
_MSG_NAMES = {
    0x0002: "link info (new-style group)",
    0x0006: "link message (compact link storage)",
    0x000A: "group info (new-style group)",
    0x000B: "filter pipeline",
    0x0016: "object reference count (version 2 header)",
    0x0018: "object header continuation of version 2",
}
_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset"}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 10: "array"}


class HDF5Error(OSError):
    """A file that is not HDF5, is cut short, or holds a structure
    outside the subset this module reads (named in the message)."""


class Reference(int):
    """An object reference: the address of the object's header."""


def _align8(n: int) -> int:
    return (n + 7) & ~7


# ------------------------------------------------------------------ datatypes


class _Type:
    """A datatype: its on-disk element size and how elements convert.

    ``kind`` is one of ``num`` (``dtype`` is the stored numpy type),
    ``bool``, ``complex``, ``fstr`` (``pad``: 0 NULLTERM, 1 NULLPAD),
    ``vstr``, ``ref``, ``vref`` (a sequence of references) and
    ``reflist`` (REFERENCE_LIST's compound)."""

    __slots__ = ("kind", "size", "dtype", "pad", "utf8")

    def __init__(self, kind, size, dtype=None, pad=0, utf8=False):
        self.kind, self.size, self.dtype, self.pad, self.utf8 = kind, size, dtype, pad, utf8

    @property
    def value_dtype(self) -> np.dtype:
        if self.kind == "num":
            return self.dtype.newbyteorder("=")
        if self.kind == "bool":
            return np.dtype(bool)
        if self.kind == "complex":
            return np.dtype(np.complex64 if self.size == 8 else np.complex128)
        return np.dtype(object)


_VLEN_DISK = np.dtype([("n", "<u4"), ("addr", "<u8"), ("idx", "<u4")])
_FLOAT_LAYOUT = {4: (31, 23, 8, 0, 23, 127), 8: (63, 52, 11, 0, 52, 1023)}


def _parse_type(buf: bytes, off: int = 0) -> tuple[_Type, int]:
    """The datatype message at ``buf[off:]``: (type, bytes it takes)."""
    cv, b0, b1, b2, size = struct.unpack_from("<BBBBI", buf, off)
    cls, version, bits = cv & 0x0F, cv >> 4, b0 | b1 << 8 | b2 << 16
    p = off + 8
    if cls == 0:
        bit_off, prec = struct.unpack_from("<HH", buf, p)
        if size not in (1, 2, 4, 8) or bit_off or prec != 8 * size:
            raise HDF5Error(f"fixed-point datatype of {size} bytes, precision {prec} is not supported")
        order = ">" if bits & 1 else "<"
        return _Type("num", size, np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")), 12
    if cls == 1:
        bit_off, prec, e_loc, e_size, m_loc, m_size, bias = struct.unpack_from("<HHBBBBI", buf, p)
        sign = (bits >> 8) & 0xFF
        if size not in _FLOAT_LAYOUT or bits & 0x40 or bit_off or prec != 8 * size or (
                sign, e_loc, e_size, m_loc, m_size, bias) != _FLOAT_LAYOUT[size]:
            raise HDF5Error(f"floating-point datatype of {size} bytes is not IEEE f4 or f8")
        return _Type("num", size, np.dtype(f"{'>' if bits & 1 else '<'}f{size}")), 20
    if cls == 3:
        pad, cset = bits & 0x0F, (bits >> 4) & 0x0F
        if pad > 1 or cset > 1:
            raise HDF5Error(f"fixed-length string with padding {pad}, character set {cset} "
                            "is not supported")
        return _Type("fstr", size, pad=pad, utf8=cset == 1), 8
    if cls == 6:
        return _parse_compound(buf, off, version, bits & 0xFFFF, size)
    if cls == 7:
        if version > 3 or bits & 0x0F:
            raise HDF5Error("region references and version 4 references are not supported")
        return _Type("ref", size), 8
    if cls == 8:
        base, used = _parse_type(buf, p)
        n, q = bits & 0xFFFF, p + used
        names = []
        for _ in range(n):
            end = buf.index(b"\0", q)
            names.append(buf[q:end].decode())
            q = end + 1 if version >= 3 else _after_name(q, end)
        values = np.frombuffer(buf, base.dtype, n, q) if base.kind == "num" else None
        q += n * base.size
        if (base.kind == "num" and base.size == 1 and names == ["FALSE", "TRUE"]
                and values.tolist() == [0, 1]):
            return _Type("bool", 1), q - off
        raise HDF5Error(f"enum datatype {names} is not supported (only h5py's bool)")
    if cls == 9:
        base, used = _parse_type(buf, p)
        if size != 16:
            raise HDF5Error(f"variable-length datatype of {size} bytes on disk is not supported")
        if bits & 0x0F == 1:
            if (bits >> 8) & 0x0F > 1:
                raise HDF5Error("variable-length string of an unknown character set")
            return _Type("vstr", 16, utf8=(bits >> 8) & 0x0F == 1), 8 + used
        if base.kind == "ref":
            return _Type("vref", 16), 8 + used
        raise HDF5Error(f"variable-length sequence of {base.kind} is not supported")
    name = _CLASS_NAMES.get(cls, f"class {cls}")
    raise HDF5Error(f"{name} datatype is not supported")


def _after_name(start: int, end: int) -> int:
    """The offset after a NUL-terminated name from ``start`` to ``end``
    (its NUL), padded to a multiple of 8 from ``start``."""
    return start + _align8(end - start + 1)


def _parse_compound(buf, off, version, n, size) -> tuple[_Type, int]:
    q = off + 8
    members = []
    for _ in range(n):
        end = buf.index(b"\0", q)
        name = buf[q:end].decode()
        if version >= 3:
            q = end + 1
            width = 1 if size < 256 else 2 if size < 65536 else 3 if size < 1 << 24 else 4
            moff = int.from_bytes(buf[q:q + width], "little")
            q += width
        else:
            q = _after_name(q, end)
            moff = struct.unpack_from("<I", buf, q)[0]
            q += 4
            if version == 1:
                if buf[q]:
                    raise HDF5Error(f"compound member {name!r} is an array")
                q += 28
        mtype, used = _parse_type(buf, q)
        q += used
        members.append((name, moff, mtype))
    names = [m[0] for m in members]
    if len(members) == 2:
        (_, off0, t0), (_, off1, t1) = members
        if (names == ["r", "i"] and t0.kind == t1.kind == "num" and t0.dtype == t1.dtype
                and t0.dtype.kind == "f" and t0.dtype.byteorder != ">"
                and off0 == 0 and off1 == t0.size and size == 2 * t0.size):
            return _Type("complex", size), q - off
        if (names == ["dataset", "dimension"] and t0.kind == "ref" and off0 == 0
                and t1.kind == "num" and t1.dtype.kind in "iu" and t1.size == 4
                and t1.dtype.byteorder != ">"):
            return _Type("reflist", size, np.dtype({"names": names, "formats": ["<u8", t1.dtype],
                                                    "offsets": [0, off1],
                                                    "itemsize": size})), q - off
    raise HDF5Error(f"compound datatype with members {names} is not supported (only h5py's "
                    "complex and REFERENCE_LIST)")


# ------------------------------------------------------------------ reading


class _Source:
    """A file opened for reading: bounded reads at absolute addresses."""

    def __init__(self, path):
        self.fd = os.open(os.fspath(path), os.O_RDONLY)
        self.size = os.fstat(self.fd).st_size
        self.heaps: dict[int, dict[int, bytes]] = {}
        self.objects: dict[int, Any] = {}

    def read(self, addr: int, n: int) -> bytes:
        if addr == _UNDEF or addr + n > self.size:
            raise HDF5Error(f"truncated file: {n} bytes at {addr} past its end ({self.size})")
        data = os.pread(self.fd, n, addr)
        while len(data) < n:
            data += os.pread(self.fd, n - len(data), addr + len(data))
        return data

    def read_into(self, addr: int, dest: memoryview) -> None:
        n = dest.nbytes
        if addr + n > self.size:
            raise HDF5Error(f"truncated file: {n} bytes at {addr} past its end ({self.size})")
        done = 0
        while done < n:
            got = os.preadv(self.fd, [dest[done:done + _IO_BYTES]], addr + done)
            if got <= 0:
                raise HDF5Error(f"truncated file: read stopped at {addr + done}")
            done += got

    def heap_object(self, addr: int, idx: int) -> bytes:
        heap = self.heaps.get(addr)
        if heap is None:
            head = self.read(addr, 16)
            if head[:4] != b"GCOL":
                raise HDF5Error(f"no global heap collection at {addr}")
            size = struct.unpack_from("<Q", head, 8)[0]
            raw, p, heap = self.read(addr, size), 16, {}
            while p + 16 <= size:
                i, _, _, n = struct.unpack_from("<HHIQ", raw, p)
                if i == 0:
                    break
                heap[i] = raw[p + 16:p + 16 + n]
                p += 16 + _align8(n)
            self.heaps[addr] = heap
        try:
            return heap[idx]
        except KeyError:
            raise HDF5Error(f"global heap collection at {addr} has no object {idx}") from None


def _messages(src: _Source, addr: int) -> list[tuple[int, int, bytes]]:
    """The (type, flags, body) messages of the version 1 object header at
    ``addr``, continuation blocks followed."""
    head = src.read(addr, 16)
    if head[:4] == b"OHDR":
        raise HDF5Error(f"version 2 object header (OHDR) at {addr} is not supported")
    version, _, n_msgs, _, size = struct.unpack_from("<BBHII", head)
    if version != 1:
        raise HDF5Error(f"object header at {addr} has version {version}")
    blocks, out, seen = [(addr + 16, size)], [], 0
    while blocks:
        start, length = blocks.pop(0)
        buf, p = src.read(start, length), 0
        while p + 8 <= length and seen < n_msgs:
            mtype, msize, flags = struct.unpack_from("<HHB", buf, p)
            body = buf[p + 8:p + 8 + msize]
            if len(body) < msize:
                raise HDF5Error(f"object header message at {start + p} runs past its block")
            seen += 1
            if mtype == 0x10:
                blocks.append(struct.unpack_from("<QQ", body))
            elif mtype:
                if flags & 0x02:
                    raise HDF5Error(f"shared object header message (type {mtype}) is not supported")
                out.append((mtype, flags, body))
            p += 8 + msize
    if seen != n_msgs:
        raise HDF5Error(f"object header at {addr} holds {seen} of its {n_msgs} messages")
    return out


def _dataspace(body: bytes) -> tuple[int, ...]:
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        p = 8
    elif version == 2:
        if body[3] == 2:
            raise HDF5Error("null dataspace is not supported")
        p = 4
    else:
        raise HDF5Error(f"dataspace message version {version} is not supported")
    return struct.unpack_from(f"<{rank}Q", body, p)


def _decode(src: _Source, raw: bytes | np.ndarray, t: _Type, shape: tuple[int, ...]):
    """Stored elements -> values (an array of ``shape``)."""
    n = math.prod(shape)
    if t.kind == "num":
        return np.frombuffer(raw, t.dtype, n).astype(t.value_dtype).reshape(shape)
    if t.kind == "bool":
        return np.frombuffer(raw, np.int8, n).astype(bool).reshape(shape)
    if t.kind == "complex":
        return np.frombuffer(raw, t.value_dtype, n).copy().reshape(shape)
    if t.kind == "ref":
        return _objects_of(np.frombuffer(raw, "<u8", n), Reference).reshape(shape)
    if t.kind == "reflist":
        rec = np.frombuffer(raw, t.dtype, n)
        out = np.empty(n, object)
        out[:] = [(Reference(int(a)), int(d)) for a, d in zip(rec["dataset"], rec["dimension"])]
        return out.reshape(shape)
    if t.kind == "fstr":
        cells = np.frombuffer(raw, f"S{t.size}", n) if t.size else np.zeros(n, "S1")
        if t.pad == 0:  # NULLTERM: the string ends at its first NUL
            cells = np.asarray([c.split(b"\0", 1)[0] for c in cells.tolist()], f"S{max(t.size, 1)}")
        return _objects_of(np.char.decode(cells, "utf-8" if t.utf8 else "ascii"), str).reshape(shape)
    # vstr, vref: (length, collection, index) elements; a run of equal
    # neighbours is found vectorized and read once, each object once
    rec = np.frombuffer(raw, _VLEN_DISK, n)
    if not n:
        return np.empty(shape, object)
    change = np.zeros(n, bool)
    change[0] = True
    for field in ("addr", "idx", "n"):
        change[1:] |= rec[field][1:] != rec[field][:-1]
    heads = rec[change]
    seen: dict[tuple, Any] = {}
    values = np.empty(len(heads), object)
    for j, key in enumerate(zip(heads["addr"].tolist(), heads["idx"].tolist(),
                                heads["n"].tolist())):
        if key not in seen:
            seen[key] = _vlen_value(src, t, *key)
        values[j] = seen[key]
    return values[np.cumsum(change) - 1].reshape(shape)


def _vlen_value(src: _Source, t: _Type, addr: int, idx: int, length: int):
    """One variable-length element: a string, or a list of references."""
    body = src.heap_object(addr, idx) if length else b""
    if t.kind == "vstr":
        if len(body) < length:
            raise HDF5Error(f"global heap object {idx} at {addr} is shorter than its string")
        return body[:length].decode("utf-8" if t.utf8 else "ascii")
    if len(body) < 8 * length:
        raise HDF5Error(f"global heap object {idx} at {addr} is shorter than its sequence")
    return [Reference(a) for a in struct.unpack_from(f"<{length}Q", body)]


def _objects_of(values: np.ndarray, kind) -> np.ndarray:
    out = np.empty(len(values), object)
    out[:] = [kind(v) for v in values.tolist()]
    return out


def _scalar(values: np.ndarray, shape: tuple[int, ...]):
    """h5py's convention: a scalar dataspace reads as a scalar."""
    return values if shape else values.reshape(())[()]


class _Attrs:
    """An object's attributes (read side, or write side when the file
    is being written)."""

    def __init__(self, obj):
        self._obj = obj

    def _table(self) -> dict:
        return self._obj._attr_table()

    def __contains__(self, name) -> bool:
        return name in self._table()

    def __getitem__(self, name):
        return self._obj._attr_value(name)

    def get(self, name, default=None):
        return self[name] if name in self else default

    def keys(self):
        return sorted(self._table(), key=str.encode)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self._table())

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __setitem__(self, name, value):
        self._obj._file._writable()
        self._obj._wattrs[name] = _encode_value(value)

    def __delitem__(self, name):
        self._obj._file._writable()
        del self._obj._wattrs[name]


class _Object:
    def __init__(self, file: "File", addr: int | None, name: str):
        self._file, self._addr, self.name = file, addr, name
        self._msgs = None
        self._wattrs: dict[str, tuple] = {}

    @property
    def attrs(self) -> _Attrs:
        return _Attrs(self)

    def _messages(self):
        if self._msgs is None:
            self._msgs = _messages(self._file._src, self._addr)
        return self._msgs

    def _attr_table(self) -> dict:
        if self._file._mode == "w":
            return self._wattrs
        table = getattr(self, "_rattrs", None)
        if table is None:
            table = {}
            for mtype, _, body in self._messages():
                if mtype == 0x0C:
                    name, rest = _attribute(body)
                    table[name] = rest
                elif mtype == 0x15:
                    _attribute_info(body)
            self._rattrs = table
        return table

    def _attr_value(self, name):
        table = self._attr_table()
        if name not in table:
            raise KeyError(f"no attribute {name!r} on {self.name}")
        if self._file._mode == "w":
            return table[name][3]
        t, shape, raw = table[name]
        return _scalar(_decode(self._file._src, raw, t, shape), shape)


def _attribute(body: bytes) -> tuple[str, tuple]:
    version = body[0]
    name_size, dt_size, ds_size = struct.unpack_from("<HHH", body, 2)
    if version == 1:
        p = 8
        name = body[p:p + name_size].split(b"\0", 1)[0].decode()
        p += _align8(name_size)
        t, _ = _parse_type(body, p)
        p += _align8(dt_size)
        shape = _dataspace(body[p:p + ds_size])
        p += _align8(ds_size)
    elif version in (2, 3):
        p = 8 if version == 2 else 9
        if body[1] & 0x03:
            raise HDF5Error("shared datatype or dataspace in an attribute is not supported")
        name = body[p:p + name_size].split(b"\0", 1)[0].decode()
        p += name_size
        t, _ = _parse_type(body, p)
        p += dt_size
        shape = _dataspace(body[p:p + ds_size])
        p += ds_size
    else:
        raise HDF5Error(f"attribute message version {version} is not supported")
    n = math.prod(shape) * t.size
    if p + n > len(body):
        raise HDF5Error(f"attribute {name!r} is cut short")
    return name, (t, shape, body[p:p + n])


def _attribute_info(body: bytes) -> None:
    flags = body[1]
    p = 2 + (2 if flags & 1 else 0)
    heap = struct.unpack_from("<Q", body, p)[0]
    if heap != _UNDEF:
        raise HDF5Error("dense attribute storage (a fractal heap) is not supported")


class Group(_Object):
    """A group: ``g[name]``, ``name in g``, ``keys()``, ``items()``,
    ``create_group``, ``create_dataset`` and ``attrs``."""

    def __init__(self, file, addr, name, btree=None, heap=None):
        super().__init__(file, addr, name)
        self._links: dict[str, _Object] | None = None if file._mode == "r" else {}
        self._btree, self._heap = btree, heap

    # ---- read side

    def _entries(self) -> dict[str, _Object]:
        if self._links is None:
            if self._btree is None:
                table = [m for m in self._messages() if m[0] == 0x11]
                for mtype, _, _ in self._messages():
                    if mtype in (0x02, 0x06, 0x0A):
                        raise HDF5Error(f"{_MSG_NAMES[mtype]} in group {self.name} is not supported")
                if not table:
                    raise HDF5Error(f"object {self.name} is not a group")
                self._btree, self._heap = struct.unpack_from("<QQ", table[0][2])
            src = self._file._src
            heap = _local_heap(src, self._heap)
            links = {}
            for entry_name, addr in _group_entries(src, self._btree, heap):
                path = f"{self.name.rstrip('/')}/{entry_name}"
                links[entry_name] = self._file._object(addr, path)
            self._links = dict(sorted(links.items(), key=lambda kv: kv[0].encode()))
        return self._links

    def __getitem__(self, name: str) -> "Group | Dataset":
        obj: Any = self
        for part in [p for p in str(name).split("/") if p]:
            if not isinstance(obj, Group):
                raise KeyError(f"{obj.name} is not a group")
            entries = obj._entries()
            if part not in entries:
                raise KeyError(f"no object {part!r} in {obj.name}")
            obj = entries[part]
        return obj

    def __contains__(self, name) -> bool:
        try:
            self[name]
            return True
        except KeyError:
            return False

    def keys(self):
        return list(self._entries())

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self._entries())

    def items(self):
        return list(self._entries().items())

    def values(self):
        return list(self._entries().values())

    # ---- write side

    def create_group(self, name: str) -> "Group":
        self._file._writable()
        self._check_new(name)
        g = Group(self._file, None, f"{self.name.rstrip('/')}/{name}")
        self._links[name] = g
        return g

    def create_dataset(self, name: str, data=None, shape=None, dtype=None) -> "Dataset":
        """A dataset from ``data`` (written at once), or of ``shape`` and
        ``dtype``, filled by row slabs (``ds[r0:r1] = rows``); rows never
        written read as zeros."""
        self._file._writable()
        self._check_new(name)
        ds = Dataset(self._file, None, f"{self.name.rstrip('/')}/{name}")
        if data is not None:
            value = _encode_value(data)
            ds._wtype, ds._shape, ds._wdata = value[0], value[1], value[2]
            if ds._wtype.kind in ("num", "bool", "complex") and math.prod(ds._shape):
                ds._reserve()
                self._file._pwrite(ds._data_addr, value[2])
            if ds._wtype.kind != "vstr":
                ds._wdata = None
            if ds._wtype.kind not in ("num", "bool", "complex", "vstr"):
                raise HDF5Error(f"a dataset of {ds._wtype.kind} is not written")
        else:
            if shape is None or dtype is None:
                raise ValueError("create_dataset needs data, or shape and dtype")
            ds._wtype = _type_of_dtype(np.dtype(dtype))
            if ds._wtype.kind not in ("num", "bool", "complex"):
                raise ValueError(f"a dataset of shape and dtype holds numbers, not {dtype}")
            ds._shape = tuple(int(n) for n in shape)
        self._links[name] = ds
        return ds

    def _check_new(self, name: str) -> None:
        if not name or "/" in name or name in ("." , ".."):
            raise ValueError(f"invalid object name {name!r}")
        if name in self._links:
            raise ValueError(f"an object named {name!r} exists in {self.name}")

    def __repr__(self):
        return f"<hdf5 group {self.name!r}>"


def _local_heap(src: _Source, addr: int) -> bytes:
    head = src.read(addr, 32)
    if head[:4] != b"HEAP":
        raise HDF5Error(f"no local heap at {addr}")
    size, _, data_addr = struct.unpack_from("<QQQ", head, 8)
    return src.read(data_addr, size)


def _heap_name(heap: bytes, offset: int) -> str:
    end = heap.find(b"\0", offset)
    if end < 0:
        raise HDF5Error(f"local heap name at {offset} is not terminated")
    return heap[offset:end].decode()


def _btree_node(src: _Source, addr: int, node_type: int, key_size: int):
    """(level, [child addresses], [key bytes]) of a version 1 B-tree node."""
    head = src.read(addr, 24)
    if head[:4] != b"TREE":
        raise HDF5Error(f"no B-tree node at {addr}")
    ntype, level, used = head[4], head[5], struct.unpack_from("<H", head, 6)[0]
    if ntype != node_type:
        raise HDF5Error(f"B-tree node at {addr} has type {ntype}, not {node_type}")
    body = src.read(addr + 24, used * (key_size + 8) + key_size)
    keys, children, p = [], [], 0
    for _ in range(used):
        keys.append(body[p:p + key_size])
        children.append(struct.unpack_from("<Q", body, p + key_size)[0])
        p += key_size + 8
    keys.append(body[p:p + key_size])
    return level, children, keys


def _group_entries(src: _Source, btree: int, heap: bytes) -> Iterator[tuple[str, int]]:
    level, children, _ = _btree_node(src, btree, 0, 8)
    for child in children:
        if level:
            yield from _group_entries(src, child, heap)
            continue
        head = src.read(child, 8)
        if head[:4] != b"SNOD":
            raise HDF5Error(f"no symbol-table node at {child}")
        n = struct.unpack_from("<H", head, 6)[0]
        raw = src.read(child + 8, 40 * n)
        for i in range(n):
            name_off, obj = struct.unpack_from("<QQ", raw, 40 * i)
            yield _heap_name(heap, name_off), obj


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype``, ``attrs``, ``ds[()]``, ``ds[r0:r1]``
    (rows), ``read_direct``; when written, ``ds[r0:r1] = rows``,
    ``make_scale`` and ``attach_scale``."""

    def __init__(self, file, addr, name):
        super().__init__(file, addr, name)
        self._shape = None
        self._wtype = None
        self._wdata = None
        self._data_addr = None
        self._layout = None
        self._map = None

    # ---- metadata

    def _meta(self):
        if self._layout is None:
            shape, t, layout, fill = None, None, None, None
            for mtype, _, body in self._messages():
                if mtype == 0x01:
                    shape = _dataspace(body)
                elif mtype == 0x03:
                    t = _parse_type(body)[0]
                elif mtype == 0x08:
                    layout = body
                elif mtype == 0x05:
                    fill = _fill_value(body)
                elif mtype == 0x0B:
                    raise HDF5Error(f"filter pipeline ({_filter_names(body)}) on {self.name} "
                                    "is not supported")
                elif mtype in _MSG_NAMES:
                    raise HDF5Error(f"{_MSG_NAMES[mtype]} in {self.name} is not supported")
            if shape is None or t is None or layout is None:
                raise HDF5Error(f"dataset {self.name} lacks its dataspace, datatype or layout")
            self._shape, self._rtype, self._fill = shape, t, fill
            self._layout = _layout(layout, self.name)
        return self._layout

    @property
    def shape(self) -> tuple[int, ...]:
        if self._file._mode == "r":
            self._meta()
        return self._shape

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def _type(self) -> _Type:
        if self._file._mode == "r":
            self._meta()
            return self._rtype
        return self._wtype

    @property
    def dtype(self) -> np.dtype:
        return self._type.value_dtype

    # ---- reading

    def __getitem__(self, key):
        if self._file._mode == "w":
            raise HDF5Error("a file open for writing is not read back")
        shape = self.shape
        if key == () or key is Ellipsis:
            r0, r1 = 0, shape[0] if shape else 0
        else:
            r0, r1 = self._rows(key)
        if not shape:
            return _scalar(self._read_raw(0, 0, ()), ())
        out_shape = (r1 - r0, *shape[1:])
        return self._read_raw(r0, r1, out_shape)

    def _rows(self, key) -> tuple[int, int]:
        if isinstance(key, tuple):
            if not key or any(k != slice(None) for k in key[1:]):
                raise IndexError("a dataset reads whole rows: ds[r0:r1] or ds[r0:r1, :]")
            key = key[0]
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise IndexError("a dataset reads a contiguous slice of rows")
        if not self.shape:
            raise IndexError("a scalar dataset reads as ds[()]")
        r0, r1, _ = key.indices(self.shape[0])
        return r0, max(r0, r1)

    def read_direct(self, dest: np.ndarray, source_sel=None) -> None:
        """Rows ``source_sel`` (a slice, or a tuple led by one) straight
        into ``dest``, a C-contiguous array of the stored type."""
        self._meta()
        t = self._rtype
        if t.kind not in ("num", "bool", "complex"):
            raise TypeError("read_direct reads numbers")
        r0, r1 = (0, self.shape[0]) if source_sel is None else self._rows(source_sel)
        want = (r1 - r0, *self.shape[1:])
        stored = t.dtype if t.kind == "num" else t.value_dtype
        if dest.shape != want or dest.dtype != stored or not dest.flags.c_contiguous:
            raise ValueError(f"read_direct needs a C-contiguous {want} {stored} array")
        self._read_into(r0, r1, dest)

    def _read_raw(self, r0, r1, out_shape):
        t = self._rtype
        if t.kind in ("num", "bool", "complex"):
            stored = t.dtype if t.kind == "num" else (np.int8 if t.kind == "bool" else t.value_dtype)
            dest = np.empty(out_shape, stored)
            self._read_into(r0, r1, dest)
            if t.kind == "num":
                return dest.astype(t.value_dtype, copy=False)
            return dest.astype(bool) if t.kind == "bool" else dest
        raw = np.empty(math.prod(out_shape) * t.size, np.uint8)
        self._read_into(r0, r1, raw)
        return _decode(self._file._src, raw.tobytes(), t, out_shape)

    def _read_into(self, r0: int, r1: int, dest: np.ndarray) -> None:
        """Rows [r0, r1) of the stored bytes into ``dest`` (C-contiguous)."""
        layout, src, t = self._meta(), self._file._src, self._rtype
        row = math.prod(self.shape[1:]) * t.size
        if not dest.nbytes:
            return
        view = memoryview(dest.reshape(-1).view(np.uint8))
        if not self.shape:
            r0, r1, row = 0, 1, t.size
        if layout[0] == "contiguous":
            addr = layout[1]
            if addr == _UNDEF:
                self._fill_into(view)
            else:
                src.read_into(addr + r0 * row, view)
        else:
            self._read_chunks(r0, r1, dest, layout[1], layout[2])

    def _fill_into(self, view: memoryview) -> None:
        fill = self._fill or b"\0"
        view[:] = fill * (view.nbytes // len(fill))

    def _read_chunks(self, r0, r1, dest, btree, chunk) -> None:
        """Rows [r0, r1) from the chunks that hold them, one read a chunk:
        straight into ``dest`` where a chunk spans whole rows, else
        through a buffer of the chunk; rows of no chunk read as the fill."""
        src, size, shape = self._file._src, self._rtype.size, self.shape
        cells = dest.reshape(-1).view(np.uint8).view(f"V{size}").reshape(r1 - r0, *shape[1:])
        whole_rows = tuple(chunk[1:]) == tuple(shape[1:])
        row = math.prod(shape[1:]) * size
        hits, covered = [], 0
        for offsets, stored, mask, addr in _chunk_index(src, btree, len(shape)):
            lo, hi = max(r0, offsets[0]), min(r1, offsets[0] + chunk[0])
            if lo < hi:
                if mask:
                    raise HDF5Error(f"filtered chunk in {self.name} is not supported")
                extent = [min(c, n - o) for o, c, n in zip(offsets[1:], chunk[1:], shape[1:])]
                hits.append((offsets, lo, hi, addr, extent))
                covered += (hi - lo) * math.prod(extent)
        if covered < cells.size:
            self._fill_into(memoryview(dest.reshape(-1).view(np.uint8)))
        for offsets, lo, hi, addr, extent in hits:
            if whole_rows:
                src.read_into(addr + (lo - offsets[0]) * row,
                              memoryview(cells[lo - r0:hi - r0].view(np.uint8).reshape(-1)))
                continue
            block = np.empty(math.prod(chunk) * size, np.uint8)
            src.read_into(addr, memoryview(block))
            block = block.view(f"V{size}").reshape(chunk)
            part = tuple(slice(0, e) for e in extent)
            target = tuple(slice(o, o + e) for o, e in zip(offsets[1:], extent))
            cells[(slice(lo - r0, hi - r0), *target)] = \
                block[(slice(lo - offsets[0], hi - offsets[0]), *part)]

    def scales(self) -> tuple[tuple[str, ...], ...]:
        """The names of the dimension scales attached to each axis."""
        if "DIMENSION_LIST" not in self.attrs:
            return tuple(() for _ in self.shape)
        return tuple(tuple(self._file._path_of(r) for r in refs)
                     for refs in self.attrs["DIMENSION_LIST"])

    # ---- writing

    def _reserve(self) -> None:
        if self._data_addr is None:
            self._data_addr = self._file._allocate(math.prod(self._shape) * self._wtype.size)

    def __setitem__(self, key, value) -> None:
        """``ds[r0:r1] = rows`` (one write at the rows' offset) or
        ``ds[r0:r1, c0:c1] = block`` (through a memory map of the data)."""
        self._file._writable()
        if self._wtype.kind not in ("num", "bool", "complex") or not self._shape:
            raise TypeError("slabs are written to a dataset of numbers")
        slices = key if isinstance(key, tuple) else (key,)
        if len(slices) > len(self._shape) or not all(
                isinstance(k, slice) and k.step in (None, 1) for k in slices):
            raise IndexError("a dataset is written by contiguous slices")
        bounds = [k.indices(n)[:2] for k, n in zip(slices, self._shape)]
        want = tuple(max(0, b - a) for a, b in bounds) + self._shape[len(slices):]
        block = np.asarray(value)
        if block.shape != want:
            raise ValueError(f"values of shape {block.shape} written to a {want} slab")
        self._reserve()
        disk = _disk_dtype(self._wtype)
        if all(k == slice(None) for k in slices[1:]):
            row = math.prod(self._shape[1:]) * self._wtype.size
            self._file._pwrite(self._data_addr + bounds[0][0] * row,
                               np.ascontiguousarray(block, dtype=disk))
            return
        if self._map is None:
            end = self._data_addr + math.prod(self._shape) * self._wtype.size
            if os.fstat(self._file._fd).st_size < end:
                os.ftruncate(self._file._fd, end)
            self._map = np.memmap(self._file.filename, disk, "r+", self._data_addr, self._shape)
        self._map[tuple(slice(a, b) for a, b in bounds)] = block

    def make_scale(self, name: str = "") -> None:
        """Mark this dataset a dimension scale (``CLASS``, ``NAME``)."""
        self.attrs["CLASS"] = _Fixed(b"DIMENSION_SCALE\0", 0)
        if name:
            self.attrs["NAME"] = _Fixed(name.encode() + b"\0", 0)

    def attach_scale(self, axis: int, scale: "Dataset") -> None:
        """Attach ``scale`` to this dataset's ``axis`` (``DIMENSION_LIST``
        here, ``REFERENCE_LIST`` on the scale)."""
        self._file._writable()
        lists = self._wattrs.get("DIMENSION_LIST")
        refs = [list(r) for r in lists[2]] if lists else [[] for _ in self._shape]
        refs[axis].append(scale)
        self._wattrs["DIMENSION_LIST"] = (_VREF, (len(self._shape),), refs, None)
        back = scale._wattrs.get("REFERENCE_LIST")
        entries = list(back[2]) if back else []
        entries.append((self, axis))
        scale._wattrs["REFERENCE_LIST"] = (_REFLIST, (len(entries),), entries, None)

    def __repr__(self):
        return f"<hdf5 dataset {self.name!r}>"


def _fill_value(body: bytes) -> bytes | None:
    """The fill value message's value (None: the default, zeros)."""
    if body[0] not in (1, 2):
        raise HDF5Error(f"fill value message version {body[0]} is not supported")
    if not body[3]:
        return None
    size = struct.unpack_from("<I", body, 4)[0]
    return body[8:8 + size]


def _filter_names(body: bytes) -> str:
    version, n = body[0], body[1]
    p, names = (8 if version == 1 else 2), []
    for _ in range(n):
        fid, = struct.unpack_from("<H", body, p)
        names.append(_FILTERS.get(fid, f"filter {fid}"))
        if version == 1 or fid >= 256:
            name_len, _, n_vals = struct.unpack_from("<HHH", body, p + 2)
            p += 8 + (_align8(name_len) if version == 1 else name_len)
        else:
            _, n_vals = struct.unpack_from("<HH", body, p + 2)
            p += 6
        p += 4 * n_vals + (4 if version == 1 and n_vals % 2 else 0)
    return ", ".join(names)


def _layout(body: bytes, name: str):
    version = body[0]
    if version != 3:
        raise HDF5Error(f"data layout message version {version} in {name} is not supported")
    cls = body[1]
    if cls == 1:
        return ("contiguous", struct.unpack_from("<Q", body, 2)[0])
    if cls == 2:
        rank1 = body[2]
        btree = struct.unpack_from("<Q", body, 3)[0]
        dims = struct.unpack_from(f"<{rank1}I", body, 11)
        return ("chunked", btree, dims[:-1])
    raise HDF5Error(f"data layout class {cls} in {name} is not supported")


def _chunk_index(src: _Source, btree: int, rank: int):
    """(offsets, stored size, filter mask, address) of every allocated
    chunk, from the version 1 B-tree of type 1 at ``btree``."""
    if btree == _UNDEF:
        return
    key_size = 8 + 8 * (rank + 1)
    level, children, keys = _btree_node(src, btree, 1, key_size)
    for key, child in zip(keys, children):
        if level:
            yield from _chunk_index(src, child, rank)
        else:
            size, mask = struct.unpack_from("<II", key)
            offsets = struct.unpack_from(f"<{rank}Q", key, 8)
            yield offsets, size, mask, child


# ------------------------------------------------------------------ writing


_VSTR = _Type("vstr", 16, utf8=True)
_VASCII = _Type("vstr", 16, utf8=False)
_VREF = _Type("vref", 16)
_REF = _Type("ref", 8)
_REFLIST = _Type("reflist", 16)
_I4 = _Type("num", 4, np.dtype("<i4"))


class _Fixed(NamedTuple):
    """A fixed-length string attribute: its bytes and padding (0 NULLTERM,
    1 NULLPAD)."""

    raw: bytes
    pad: int


def _type_of_dtype(dt: np.dtype) -> _Type:
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8) or dt.kind == "f" and dt.itemsize in (4, 8):
        return _Type("num", dt.itemsize, dt.newbyteorder("<"))
    if dt.kind == "b":
        return _Type("bool", 1)
    if dt.kind == "c" and dt.itemsize in (8, 16):
        return _Type("complex", dt.itemsize)
    raise HDF5Error(f"numpy type {dt} has no HDF5 type in this module")


def _disk_dtype(t: _Type) -> np.dtype:
    """The numpy type of a number-like type's stored elements."""
    return t.dtype if t.kind == "num" else np.dtype(np.int8) if t.kind == "bool" else t.value_dtype


def _encode_value(value) -> tuple:
    """(type, shape, payload, the value as it reads back) of a Python or
    numpy value, typed as h5py types it: str -> variable-length UTF-8,
    bytes -> variable-length ASCII, ``np.bytes_`` -> fixed-length
    NULLPAD, an array of str -> variable-length strings, numbers and
    bools -> their numpy types."""
    if isinstance(value, np.bytes_):
        value = _Fixed(bytes(value), 1)
    elif isinstance(value, bytes):
        text = value.decode("ascii")
        return _VASCII, (), np.array([text], object), text
    if isinstance(value, _Fixed):
        t = _Type("fstr", max(len(value.raw), 1), pad=value.pad)
        shown = value.raw.split(b"\0", 1)[0] if value.pad == 0 else value.raw.rstrip(b"\0")
        return t, (), value.raw.ljust(t.size, b"\0"), shown.decode()
    if isinstance(value, str):
        return _VSTR, (), np.array([value], object), value
    if type(value) in (bool, int, float, complex):
        value = {bool: np.bool_, int: np.int64, float: np.float64,
                 complex: np.complex128}[type(value)](value)
    arr = np.asarray(value)
    if arr.dtype.kind in "OU":
        strings = np.ascontiguousarray(arr.astype(object))
        if not all(issubclass(kind, str) for kind in set(map(type, strings.flat))):
            raise HDF5Error("an array of objects is written only when it holds str")
        return _VSTR, arr.shape, strings, strings if arr.ndim else strings[()]
    t = _type_of_dtype(arr.dtype)
    return t, arr.shape, np.ascontiguousarray(arr, _disk_dtype(t)), arr.astype(t.value_dtype)[()]


def _type_bytes(t: _Type) -> bytes:
    """The version 1 datatype message of a type the writer makes."""
    if t.kind == "num":
        if t.dtype.kind == "f":
            sign, e_loc, e_size, m_loc, m_size, bias = _FLOAT_LAYOUT[t.size]
            return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, t.size, 0, 8 * t.size,
                               e_loc, e_size, m_loc, m_size, bias)
        return struct.pack("<BBBBIHH", 0x10, 0x08 if t.dtype.kind == "i" else 0, 0, 0, t.size,
                           0, 8 * t.size)
    if t.kind == "bool":
        return (struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + struct.pack("<BBBBIHH", 0x10, 0x08, 0, 0,
                                                                      1, 0, 8)
                + b"FALSE\0\0\0TRUE\0\0\0\0\x00\x01")
    if t.kind == "fstr":
        return struct.pack("<BBBBI", 0x13, t.pad, 0, 0, t.size)
    if t.kind == "vstr":
        return struct.pack("<BBBBIBBBBIHH", 0x19, 0x01, int(t.utf8), 0, 16, 0x10, 0, 0, 0, 1, 0,
                           8)
    if t.kind == "ref":
        return struct.pack("<BBBBI", 0x17, 0, 0, 0, 8)
    if t.kind == "vref":
        return struct.pack("<BBBBI", 0x19, 0, 0, 0, 16) + _type_bytes(_REF)
    if t.kind == "complex":
        part = _type_bytes(_Type("num", t.size // 2, np.dtype(f"<f{t.size // 2}")))
        members = [(b"r", 0, part), (b"i", t.size // 2, part)]
    else:  # reflist
        members = [(b"dataset", 0, _type_bytes(_REF)), (b"dimension", 8, _type_bytes(_I4))]
    body = b"".join(name.ljust(_align8(len(name) + 1), b"\0")
                    + struct.pack("<IB3xI4x16x", offset, 0, 0) + mtype
                    for name, offset, mtype in members)
    return struct.pack("<BBBBI", 0x16, len(members), 0, 0, t.size) + body


def _space_bytes(shape: tuple[int, ...]) -> bytes:
    return struct.pack(f"<BBBxI{len(shape)}Q", 1, len(shape), 0, 0, *shape)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body.ljust(_align8(len(body)), b"\0")
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _padded(raw: bytes) -> bytes:
    return raw.ljust(_align8(len(raw)), b"\0")


class _Heap:
    """The global heap being written: each distinct string once, each
    reference sequence on its own, in collections of at most 65535
    objects and at least ``_HEAP_MIN`` bytes."""

    def __init__(self):
        self.payloads: list = []  # bytes, or a list of objects whose addresses are stored
        self._strings: dict[str, int] = {}

    def strings(self, values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(object, length) of each string of ``values``: equal
        neighbours are found vectorized, the runs' first strings by a dict."""
        flat = np.asarray(values, object).reshape(-1)
        if not flat.size:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        change = np.ones(flat.size, bool)
        change[1:] = flat[1:] != flat[:-1]
        firsts = [self._string(v) for v in flat[change].tolist()]
        runs = np.cumsum(change) - 1
        ids = np.asarray([i for i, _ in firsts], np.int64)[runs]
        return ids, np.asarray([n for _, n in firsts], np.int64)[runs]

    def _string(self, value: str) -> tuple[int, int]:
        i = self._strings.get(value)
        if i is None:
            i = self._strings[value] = len(self.payloads)
            self.payloads.append(value.encode())
        return i, len(self.payloads[i])

    def sequences(self, lists) -> tuple[np.ndarray, np.ndarray]:
        ids = []
        for refs in lists:
            ids.append(len(self.payloads))
            self.payloads.append(list(refs))
        return np.asarray(ids, np.int64), np.asarray([len(r) for r in lists], np.int64)

    def place(self, allocate) -> None:
        """Reserve the collections; ``where[i]`` = (address, index)."""
        self.collections, self.where = [], np.zeros((len(self.payloads), 2), np.int64)
        for c0 in range(0, len(self.payloads), 65535):
            items = range(c0, min(c0 + 65535, len(self.payloads)))
            used = 16 + sum(16 + _align8(self._size(i)) for i in items)
            size = max(_HEAP_MIN, used)
            addr = allocate(size)
            self.collections.append((addr, size, items))
            self.where[c0:c0 + len(items), 0] = addr
            self.where[c0:c0 + len(items), 1] = np.arange(1, len(items) + 1)

    def _size(self, i: int) -> int:
        p = self.payloads[i]
        return len(p) if isinstance(p, bytes) else 8 * len(p)

    def write(self, pwrite) -> None:
        for addr, size, items in self.collections:
            out = bytearray(struct.pack("<4sB3xQ", b"GCOL", 1, size))
            for j, i in enumerate(items):
                p = self.payloads[i]
                raw = p if isinstance(p, bytes) else struct.pack(f"<{len(p)}Q", *[o._waddr for o in p])
                out += struct.pack("<HHIQ", j + 1, 1, 0, len(raw)) + _padded(raw)
            if size - len(out) >= 16:  # the free space, its own header counted
                out += struct.pack("<HHIQ", 0, 0, 0, size - len(out))
            pwrite(addr, bytes(out.ljust(size, b"\0")))

    def elements(self, ids: np.ndarray, lengths: np.ndarray) -> bytes:
        rec = np.zeros(len(ids), _VLEN_DISK)
        rec["n"], rec["addr"], rec["idx"] = lengths, self.where[ids, 0], self.where[ids, 1]
        return rec.tobytes()




class File(Group):
    """An HDF5 file: ``File(path, "r")`` reads, ``File(path, "w")``
    creates (truncating); use it as a context manager."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError("mode is 'r' or 'w'")
        self._mode, self.filename = mode, os.fspath(path)
        self._file = self
        if mode == "r":
            self._src = _Source(path)
            try:
                root, btree, heap = self._superblock()
            except BaseException:
                os.close(self._src.fd)
                raise
            super().__init__(self, root, "/", btree, heap)
            self._src.objects[root] = self
        else:
            self._fd = os.open(self.filename, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
            self._end = 96  # the superblock's bytes come first
            super().__init__(self, None, "/")
        self._closed = False
        self._paths: dict[int, str] | None = None

    # ---- reading

    def _superblock(self):
        src = self._src
        if src.size < 96 or src.read(0, 8) != _SIGNATURE:
            raise HDF5Error(f"{self.filename} is not an HDF5 file (no signature at its start)")
        head = src.read(0, 24)
        version = head[8]
        if version > 1:
            raise HDF5Error(f"superblock version {version} (libver 'latest' or v110+) "
                            "is not supported")
        if head[13] != 8 or head[14] != 8:
            raise HDF5Error(f"offsets of {head[13]} and lengths of {head[14]} bytes "
                            "are not supported")
        p = 24 + (4 if version == 1 else 0)
        addrs = struct.unpack("<QQQQ", src.read(p, 32))
        if addrs[0] != 0:
            raise HDF5Error("a superblock base address other than 0 is not supported")
        entry = src.read(p + 32, 40)
        _, root, cache = struct.unpack_from("<QQI", entry)
        btree, heap = struct.unpack_from("<QQ", entry, 24) if cache == 1 else (None, None)
        return root, btree, heap

    def _object(self, addr: int, path: str):
        objects = self._src.objects
        if addr not in objects:
            msgs = _messages(self._src, addr)
            types = {m[0] for m in msgs}
            if 0x08 in types:
                obj = Dataset(self, addr, path)
            elif types & {0x11, 0x02, 0x06, 0x0A}:
                obj = Group(self, addr, path)
            else:
                raise HDF5Error(f"object {path} is neither a dataset nor a group")
            obj._msgs = msgs
            objects[addr] = obj
        return objects[addr]

    def _path_of(self, ref: int) -> str:
        if self._paths is None:
            self._paths = {}
            stack = [self]
            while stack:
                g = stack.pop()
                for obj in g.values():
                    self._paths.setdefault(obj._addr, obj.name)
                    if isinstance(obj, Group):
                        stack.append(obj)
        if ref not in self._paths:
            raise HDF5Error(f"reference {ref} points to no object of the file")
        return self._paths[ref]

    # ---- writing

    def _writable(self) -> None:
        if self._mode != "w" or self._closed:
            raise HDF5Error("the file is not open for writing")

    def _allocate(self, n: int) -> int:
        addr = self._end
        self._end = _align8(self._end + n)
        return addr

    def _pwrite(self, addr: int, data) -> None:
        view = memoryview(data).cast("B")
        done = 0
        while done < view.nbytes:
            done += os.pwrite(self._fd, view[done:done + _IO_BYTES], addr + done)

    def _finish(self) -> None:
        """Lay out the metadata after the data, write it, then the
        superblock."""
        objects: list[_Object] = []

        def walk(g: Group):
            objects.append(g)
            for child in g._links.values():
                walk(child) if isinstance(child, Group) else objects.append(child)

        walk(self)
        for obj in objects:
            if getattr(obj, "_map", None) is not None:
                obj._map.flush()
                obj._map = None
        groups = [o for o in objects if isinstance(o, Group)]
        leaf_k = max(4, math.ceil(max(len(g._links) for g in groups) / 2))
        heap, vlen = _Heap(), {}
        for obj in objects:
            for name, (t, shape, payload, _) in obj._wattrs.items():
                if t.kind == "vstr":
                    vlen[id(obj), name] = heap.strings(payload)
                elif t.kind == "vref":
                    vlen[id(obj), name] = heap.sequences(payload)
            if isinstance(obj, Dataset) and obj._wtype.kind == "vstr":
                vlen[id(obj), None] = heap.strings(obj._wdata)
        heap.place(self._allocate)
        for obj in objects:
            if isinstance(obj, Dataset) and obj._wtype.kind == "vstr" and math.prod(obj._shape):
                obj._reserve()

        def attribute(obj, name, t, shape, payload) -> bytes:
            if t.kind in ("vstr", "vref"):
                data = heap.elements(*vlen[id(obj), name])
            elif t.kind == "reflist":
                rec = np.zeros(len(payload), [("r", "<u8"), ("d", "<i4"), ("pad", "<i4")])
                rec["r"] = [o._waddr for o, _ in payload]
                rec["d"] = [axis for _, axis in payload]
                data = rec.tobytes()
            else:
                data = bytes(payload) if isinstance(payload, bytes) else payload.tobytes()
            raw_name, dt, ds = name.encode() + b"\0", _type_bytes(t), _space_bytes(shape)
            body = (struct.pack("<BxHHH", 1, len(raw_name), len(dt), len(ds)) + _padded(raw_name)
                    + _padded(dt) + _padded(ds) + data)
            if len(body) > 0xFFF8:
                raise HDF5Error(f"attribute {name!r} of {len(body)} bytes needs dense attribute "
                                "storage, which is not written")
            return _message(0x0C, body)

        def header(obj) -> bytes:
            if isinstance(obj, Group):
                msgs = [_message(0x11, struct.pack("<QQ", obj._wbtree, obj._wlheap))]
            else:
                t, shape = obj._wtype, obj._shape
                addr = _UNDEF if obj._data_addr is None else obj._data_addr
                msgs = [_message(0x01, _space_bytes(shape)),
                        _message(0x03, _type_bytes(t), flags=1),
                        _message(0x05, struct.pack("<BBBBI", 2, 2, 2, 1, 0), flags=1),
                        _message(0x08, struct.pack("<BBQQ", 3, 1, addr,
                                                   math.prod(shape) * t.size))]
            msgs += [attribute(obj, name, *value[:3]) for name, value in obj._wattrs.items()]
            body = b"".join(msgs)
            return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body

        snod_size = 8 + 2 * leaf_k * 40
        btree_size = 24 + (4 * _INTERNAL_K + 1) * 8
        for obj in objects:  # sizes do not depend on addresses: place with zeros first
            obj._waddr = obj._wbtree = obj._wlheap = 0
        sizes = [len(header(obj)) for obj in objects]
        for obj, size in zip(objects, sizes):
            obj._waddr = self._allocate(size)
            if isinstance(obj, Group):
                names = sorted(obj._links, key=str.encode)
                heap_data, offsets = bytearray(8), {}
                for name in names:
                    offsets[name] = len(heap_data)
                    heap_data += _padded(name.encode() + b"\0")
                obj._wnames, obj._wheap_data = (names, offsets), bytes(heap_data)
                obj._wlheap = self._allocate(32 + len(heap_data))
                obj._wbtree = self._allocate(btree_size)
                obj._wsnod = self._allocate(snod_size)
        heap.write(self._pwrite)
        for obj, size in zip(objects, sizes):
            if isinstance(obj, Dataset) and obj._wtype.kind == "vstr" and obj._data_addr is not None:
                self._pwrite(obj._data_addr, heap.elements(*vlen[id(obj), None]))
            raw = header(obj)
            assert len(raw) == size
            self._pwrite(obj._waddr, raw)
            if isinstance(obj, Group):
                names, offsets = obj._wnames
                self._pwrite(obj._wlheap, struct.pack("<4sB3xQQQ", b"HEAP", 0, len(obj._wheap_data),
                                                      _FREE_NULL, obj._wlheap + 32)
                             + obj._wheap_data)
                node = struct.pack("<4sBBHQQQ", b"TREE", 0, 0, 1 if names else 0, _UNDEF, _UNDEF, 0)
                if names:
                    node += struct.pack("<QQ", obj._wsnod, offsets[names[-1]])
                self._pwrite(obj._wbtree, node.ljust(btree_size, b"\0"))
                snod = bytearray(struct.pack("<4sBxH", b"SNOD", 1, len(names)))
                for name in names:
                    child = obj._links[name]
                    if isinstance(child, Group):
                        snod += struct.pack("<QQI4xQQ", offsets[name], child._waddr, 1,
                                            child._wbtree, child._wlheap)
                    else:
                        snod += struct.pack("<QQI4x16x", offsets[name], child._waddr, 0)
                self._pwrite(obj._wsnod, bytes(snod.ljust(snod_size, b"\0")))
        superblock = (struct.pack("<8sBBBBBBBBHHI", _SIGNATURE, 0, 0, 0, 0, 0, 8, 8, 0, leaf_k,
                                  _INTERNAL_K, 0)
                      + struct.pack("<QQQQ", 0, _UNDEF, self._end, _UNDEF)
                      + struct.pack("<QQI4xQQ", 0, self._waddr, 1, self._wbtree, self._wlheap))
        self._pwrite(0, superblock)
        os.ftruncate(self._fd, self._end)


    # ---- both

    def close(self, finish: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        if self._mode == "r":
            os.close(self._src.fd)
            return
        try:
            if finish:
                self._finish()
        finally:
            os.close(self._fd)

    def __enter__(self) -> "File":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(finish=exc_type is None)

    def __repr__(self):
        return f"<hdf5 file {self.filename!r} ({self._mode})>"
