"""HDF5 files in numpy and the standard library.

The port reads the HDF5 files that h5py 3 (libhdf5 1.14) and netCDF-4
write, and writes the subset of the format that the package's own files
use, with no HDF5 library underneath.  The structures are those of the
*HDF5 File Format Specification*.

Read:

- superblocks of versions 0 to 3, 8-byte offsets and lengths (a version 2
  or 3 superblock's checksum verified; its extension read for what it
  refuses);
- object headers of version 1 and version 2 (``OHDR``, with the optional
  times, attribute-phase limits and creation-order fields, and ``OCHK``
  continuation blocks), each continuation followed;
- groups as symbol tables (a version 1 B-tree of type 0, a local heap,
  symbol-table nodes) and new-style groups: link info, group info and
  link messages (compact links), or a fractal heap of links indexed by a
  version 2 B-tree (dense links, record type 5); hard links are followed;
- attributes as messages of versions 1 to 3 (compact), or in a fractal
  heap indexed by a version 2 B-tree (dense, record type 8); the keys of
  a group or of an object's attributes come in creation order where it
  is tracked, as h5py lists them, else in the order of their names;
- fractal heaps (``FRHP``, direct blocks ``FHDB``, indirect blocks
  ``FHIB``) of managed and unfiltered huge objects, and version 2
  B-trees (``BTHD``, ``BTIN``, ``BTLF``);
- scalar and simple dataspaces (versions 1 and 2);
- datatypes: fixed-point (1, 2, 4, 8 bytes), IEEE floating-point (4, 8
  bytes) of either byte order, h5py's bool (an int8 enum FALSE/TRUE),
  h5py's complex (a compound of ``r`` and ``i``), fixed-length strings
  (NULLTERM, NULLPAD), variable-length strings through global-heap
  collections, object references, and the two types of dimension scales:
  ``DIMENSION_LIST`` (a variable-length sequence of object references)
  and ``REFERENCE_LIST`` (a compound of a reference and an int32);
- fill values (fill value messages of versions 1 to 3);
- data layout messages of versions 3 and 4: compact, contiguous and
  chunked data, the chunks indexed by a version 1 B-tree of type 1, a
  single chunk, an implicit index, a fixed array (``FAHD``/``FADB``,
  paged), an extensible array (``EAHD``/``EAIB``/``EASB``/``EADB``) or a
  version 2 B-tree (record types 10 and 11);
- the filter pipeline (versions 1 and 2) with deflate, shuffle and
  fletcher32, undone in reverse order, each chunk's filter mask honoured.
  A filtered chunk is read whole, decoded (chunks in threads) and its
  rows copied out.

Every checksum of the structures above is verified: Jenkins' lookup3 on
each version 2 structure, Fletcher-32 on fletcher32's chunks.  Anything
else is refused with an :class:`HDF5Error` (an ``OSError``) that names
the structure: a superblock of version 4 or later, a superblock
extension's shared-message table, shared or committed messages, soft,
external and user-defined links, a filter other than the three (szip,
nbit, scaleoffset, h5py's LZF and any other id), a filtered fractal heap,
tiny and filtered huge heap objects, virtual layouts, a null dataspace, a
datatype outside the list above.  A truncated, corrupted or foreign file
raises the same error; nothing here returns a value it could not read.

The writer writes the first subset only: superblock version 0, version 1
object headers, groups as symbol tables, compact attributes, contiguous
data.  A dataset's data is at one offset reserved when it is first
written (a slab of rows goes there at once, ``ds[r0:r1] = rows``); the
metadata (object headers, heaps, B-trees, the global heap) is laid out
when the file is closed.  Equal strings of one file share one
global-heap object, and every group's entries fit in one symbol-table
node (the superblock's group leaf K is set for it).  One sequence of
calls gives one file, byte for byte.

Strings come back as ``str``: a scalar as ``str``, an array as an object
array of ``str``.
"""

from __future__ import annotations

import functools
import math
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, NamedTuple

import numpy as np

__all__ = ["HDF5Error", "File", "Group", "Dataset", "Reference"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF  # an undefined address; an unlimited dimension
_IO_BYTES = 1 << 30  # the most bytes one read or write system call is given
_HEAP_MIN = 4096  # a global-heap collection's least size (libhdf5 reads that much first)
_FREE_NULL = 1  # a local heap's "no free block" offset
_INTERNAL_K = 16  # group B-tree internal node K
_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
            32000: "lzf"}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 10: "array"}
_M32 = 0xFFFFFFFF
_DECODE_THREADS = 8  # the most threads that decode one read's filtered chunks


class HDF5Error(OSError):
    """A file that is not HDF5, is cut short, or holds a structure
    outside the subset this module reads (named in the message)."""


class Reference(int):
    """An object reference: the address of the object's header."""


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _parsing(fn):
    """``fn`` with a malformed structure's parse errors raised as
    :class:`HDF5Error`: a field past its block's end, a bad name."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (struct.error, IndexError, ValueError, UnicodeDecodeError, zlib.error,
                OverflowError) as err:
            raise HDF5Error(f"malformed structure ({type(err).__name__}: {err})") from err

    return call


# ------------------------------------------------------------------ checksums


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def _lookup3(data) -> int:
    """Jenkins' lookup3 ``hashlittle`` of ``data`` with initial value 0:
    the checksum of every version 2 metadata structure."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n) & _M32
    if not n:
        return c
    full = (n - 1) // 12  # the last 1-12 bytes take the final mix
    tail = bytes(data[12 * full:]).ljust(12, b"\0")
    w = struct.unpack_from(f"<{3 * full}I", data) + struct.unpack("<3I", tail)
    for i in range(0, 3 * full, 3):
        a, b, c = (a + w[i]) & _M32, (b + w[i + 1]) & _M32, (c + w[i + 2]) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 4)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 6)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 8)
        b = (b + a) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 16)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 19)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 4)
        b = (b + a) & _M32
    a, b, c = (a + w[-3]) & _M32, (b + w[-2]) & _M32, (c + w[-1]) & _M32
    c = ((c ^ b) - _rot(b, 14)) & _M32
    a = ((a ^ c) - _rot(c, 11)) & _M32
    b = ((b ^ a) - _rot(a, 25)) & _M32
    c = ((c ^ b) - _rot(b, 16)) & _M32
    a = ((a ^ c) - _rot(c, 4)) & _M32
    b = ((b ^ a) - _rot(a, 14)) & _M32
    return ((c ^ b) - _rot(b, 24)) & _M32


def _checksummed(raw: bytes, what: str) -> bytes:
    """``raw`` less its last 4 bytes, which must hold lookup3 of the rest."""
    if len(raw) < 4 or _lookup3(raw[:-4]) != struct.unpack_from("<I", raw, len(raw) - 4)[0]:
        raise HDF5Error(f"{what} fails its checksum")
    return raw[:-4]


def _fletcher32(data) -> int:
    """libhdf5's Fletcher-32 of ``data`` (big-endian 16-bit words, an odd
    last byte the high byte of a word): both sums mod 65535, each 65535
    rather than 0 unless every word is 0, as its 360-word folds give."""
    raw = np.frombuffer(data, np.uint8)
    words = raw[:len(raw) & ~1].view(">u2").astype(np.int64)
    if len(raw) & 1:
        words = np.append(words, np.int64(raw[-1]) << 8)
    if not words.any():
        return 0
    weights = np.arange(len(words), 0, -1, dtype=np.int64) % 65535
    s1 = (int(words.sum()) % 65535 - 1) % 65535 + 1
    s2 = (int(words @ weights) % 65535 - 1) % 65535 + 1
    return s2 << 16 | s1


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
        self.fractal: dict[int, _FractalHeap] = {}
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

    def signed(self, addr: int, n: int, signature: bytes, what: str) -> bytes:
        """``n`` bytes at ``addr`` that start with ``signature`` and end
        with their checksum, the checksum verified and dropped."""
        raw = self.read(addr, n)
        if raw[:4] != signature:
            raise HDF5Error(f"no {what} ({signature.decode()}) at {addr}")
        return _checksummed(raw, f"{what} ({signature.decode()}) at {addr}")

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

    def fractal_heap(self, addr: int) -> "_FractalHeap":
        if addr not in self.fractal:
            self.fractal[addr] = _FractalHeap(self, addr)
        return self.fractal[addr]


class _Message(NamedTuple):
    """An object header message: its type, flags, body and creation
    order (None where the header does not track it)."""

    type: int
    flags: int
    body: bytes
    order: int | None


@_parsing
def _messages(src: _Source, addr: int) -> list[_Message]:
    """The messages of the object header at ``addr`` (version 1 or 2),
    continuation blocks followed."""
    head = src.read(addr, 16)
    if head[:4] == b"OHDR":
        return _messages_v2(src, addr)
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
                _unshared(mtype, flags)
                out.append(_Message(mtype, flags, body, None))
            p += 8 + msize
    if seen != n_msgs:
        raise HDF5Error(f"object header at {addr} holds {seen} of its {n_msgs} messages")
    return out


def _unshared(mtype: int, flags: int) -> None:
    if flags & 0x02:
        raise HDF5Error(f"shared object header message (type {mtype}) is not supported")


def _messages_v2(src: _Source, addr: int) -> list[_Message]:
    """The messages of the version 2 object header (``OHDR``) at ``addr``
    and of its continuation blocks (``OCHK``), each checksum verified."""
    what = f"version 2 object header (OHDR) at {addr}"
    version, flags = src.read(addr + 4, 2)
    if version != 2:
        raise HDF5Error(f"{what} has version {version}")
    p = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 0x03)
    size = int.from_bytes(src.read(addr + p, width), "little")
    blocks = [(_checksummed(src.read(addr, p + width + size + 4), what), p + width, what)]
    tracked = bool(flags & 0x04)
    head = 6 if tracked else 4
    out, seen = [], {addr}
    while blocks:
        buf, q, where = blocks.pop(0)
        while q + head <= len(buf):  # fewer bytes than a message header: the gap
            mtype, msize, mflags = struct.unpack_from("<BHB", buf, q)
            body = buf[q + head:q + head + msize]
            if len(body) < msize:
                raise HDF5Error(f"a message of the {where} runs past its block")
            if mtype == 0x10:
                c_addr, c_len = struct.unpack_from("<QQ", body)
                if c_addr in seen:
                    raise HDF5Error(f"the {what} continues into itself at {c_addr}")
                seen.add(c_addr)
                c_what = f"object header continuation block (OCHK) at {c_addr}"
                raw = src.read(c_addr, c_len)
                if raw[:4] != b"OCHK":
                    raise HDF5Error(f"no {c_what}")
                blocks.append((_checksummed(raw, c_what), 4, c_what))
            elif mtype:
                _unshared(mtype, mflags)
                order = struct.unpack_from("<H", buf, q + 4)[0] if tracked else None
                out.append(_Message(mtype, mflags, body, order))
            q += head + msize
    return out


def _dataspace(body: bytes, with_max: bool = False):
    """A dataspace message's dimensions (and, ``with_max``, its maximum
    dimensions: ``_UNDEF`` where unlimited)."""
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        p = 8
    elif version == 2:
        if body[3] == 2:
            raise HDF5Error("null dataspace is not supported")
        p = 4
    else:
        raise HDF5Error(f"dataspace message version {version} is not supported")
    dims = struct.unpack_from(f"<{rank}Q", body, p)
    maxdims = struct.unpack_from(f"<{rank}Q", body, p + 8 * rank) if flags & 1 else dims
    if any(d > m for d, m in zip(dims, maxdims) if m != _UNDEF):
        raise HDF5Error(f"dataspace of dimensions {dims} past its maximum {maxdims}")
    return (dims, maxdims) if with_max else dims


@_parsing
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


def _in_order(entries: list[tuple]) -> list[tuple]:
    """(order, name, ...) entries in creation order where every entry
    has one, else in the order of their names' bytes (h5py's order)."""
    if entries and all(e[0] is not None for e in entries):
        return sorted(entries, key=lambda e: e[0])
    return sorted(entries, key=lambda e: e[1].encode())


# ------------------------------------------------------------------ fractal heaps, v2 B-trees


def _enc_size(n: int) -> int:
    """The bytes libhdf5 takes to store counts up to ``n``."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


class _FractalHeap:
    """A fractal heap (``FRHP``): its objects by heap ID.  Managed objects
    are found through the doubling table of direct (``FHDB``) and
    indirect (``FHIB``) blocks; huge ones at their own address, found
    through the heap's version 2 B-tree of huge objects unless the ID
    holds it.  Tiny objects (in the ID itself) are refused: the heaps of
    links and attributes never hold one, their IDs being shorter than
    the least link or attribute message."""

    def __init__(self, src: _Source, addr: int):
        what = "fractal heap header"
        head = src.read(addr, 146)
        if head[:4] != b"FRHP":
            raise HDF5Error(f"no {what} (FRHP) at {addr}")
        (_, version, self.id_len, filter_len, flags, self.max_man, _, self.huge_tree, _, _, _,
         _, _, _, _, _, _, _, self.width, self.start, self.max_direct, self.max_bits,
         _, self.root, self.root_rows) = struct.unpack_from("<4sBHHBIQQQQQQQQQQQQHQQHHQH", head)
        if version != 0:
            raise HDF5Error(f"{what} at {addr} has version {version}")
        if filter_len:
            raise HDF5Error(f"filtered fractal heap at {addr} is not supported")
        _checksummed(head, f"{what} (FRHP) at {addr}")
        self.src, self.addr, self.check_direct = src, addr, bool(flags & 0x02)
        self.off_size = (self.max_bits + 7) // 8
        self.len_size = min((self.max_direct.bit_length() - 1 + 7) // 8, _enc_size(self.max_man))
        self.max_direct_rows = (self.max_direct.bit_length() - self.start.bit_length()) + 2
        self.huge: dict[int, tuple[int, int]] | None = None
        self.indirect: dict[int, tuple[int, ...]] = {}  # each indirect block's child addresses

    def row_size(self, row: int) -> int:
        return self.start if row == 0 else self.start << (row - 1)

    def get(self, heap_id: bytes) -> bytes:
        flag = heap_id[0]
        if flag >> 6:
            raise HDF5Error(f"heap ID of version {flag >> 6} in the fractal heap at {self.addr}")
        kind = (flag >> 4) & 0x03
        if kind == 0:
            p = 1 + self.off_size
            offset = int.from_bytes(heap_id[1:p], "little")
            length = int.from_bytes(heap_id[p:p + self.len_size], "little")
            return self._managed(offset, length)
        if kind == 1:
            if self.id_len - 1 >= 16:  # the ID holds the object's address and length
                addr, length = struct.unpack_from("<QQ", heap_id, 1)
            else:
                addr, length = self._huge_objects(int.from_bytes(heap_id[1:], "little"))
            return self.src.read(addr, length)
        raise HDF5Error(f"{'tiny' if kind == 2 else f'type {kind}'} object in the fractal heap at "
                        f"{self.addr} is not supported")

    def _huge_objects(self, key: int) -> tuple[int, int]:
        if self.huge is None:
            self.huge = {}
            for rec in _btree2_records(self.src, self.huge_tree, (1,)):
                addr, length, obj = struct.unpack_from("<QQQ", rec)
                self.huge[obj] = (addr, length)
        if key not in self.huge:
            raise HDF5Error(f"huge object {key} is not in the fractal heap at {self.addr}")
        return self.huge[key]

    def _managed(self, offset: int, length: int) -> bytes:
        if self.root == _UNDEF:
            raise HDF5Error(f"the fractal heap at {self.addr} is empty")
        block, block_off, rows = self.root, 0, self.root_rows
        size = self.start
        while rows:  # down the indirect blocks to the direct block that holds the offset
            block, block_off, rows, size = self._child(block, block_off, rows, offset)
        what = f"fractal heap direct block (FHDB) at {block}"
        raw = bytearray(self.src.read(block, size))
        if raw[:4] != b"FHDB":
            raise HDF5Error(f"no {what}")
        at = 13 + self.off_size
        if self.check_direct:
            stored = struct.unpack_from("<I", raw, at)[0]
            raw[at:at + 4] = bytes(4)
            if _lookup3(bytes(raw)) != stored:
                raise HDF5Error(f"{what} fails its checksum")
        local = offset - block_off
        if local < at or local + length > size:
            raise HDF5Error(f"heap object at offset {offset} lies outside the {what}")
        return bytes(raw[local:local + length])

    def _child(self, block: int, block_off: int, rows: int, offset: int):
        """The child of the indirect block at ``block`` that holds heap
        ``offset``: (address, heap offset, rows (0: direct), size)."""
        direct_rows = min(rows, self.max_direct_rows)
        addrs = self.indirect.get(block)
        if addrs is None:
            entries = rows * self.width
            raw = self.src.signed(block, 13 + self.off_size + 8 * entries + 4, b"FHIB",
                                  "fractal heap indirect block")
            addrs = self.indirect[block] = struct.unpack_from(f"<{entries}Q", raw, 13 + self.off_size)
        rel, start = offset - block_off, 0
        for row in range(rows):
            size = self.row_size(row)
            if rel < start + self.width * size:
                col = (rel - start) // size
                child = addrs[row * self.width + col]
                if child == _UNDEF:
                    raise HDF5Error(f"heap offset {offset} falls in an unallocated block")
                child_off = block_off + start + col * size
                if row < direct_rows:
                    return child, child_off, 0, size
                child_rows = size.bit_length() - (self.start * self.width).bit_length() + 1
                return child, child_off, child_rows, size
            start += self.width * size
        raise HDF5Error(f"heap offset {offset} lies past the fractal heap at {self.addr}")


def _btree2_records(src: _Source, addr: int, types: tuple[int, ...]) -> Iterator[bytes]:
    """The records, in order, of the version 2 B-tree (``BTHD``) at
    ``addr``, which must be of one of ``types``."""
    raw = src.signed(addr, 38, b"BTHD", "version 2 B-tree header")
    version, btype, node_size, rec_size, depth, _, _, root, root_n = struct.unpack_from(
        "<BBIHHBBQH", raw, 4)
    if version != 0 or btype not in types:
        raise HDF5Error(f"version 2 B-tree at {addr} has version {version}, type {btype} "
                        f"(expected {'/'.join(map(str, types))})")
    leaf_max = (node_size - 10) // rec_size
    nrec_size = _enc_size(leaf_max)
    cum_max, cum_size = [leaf_max], [0]
    for level in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[level - 1] if level > 1 else 0)
        n_max = (node_size - 10 - ptr) // (rec_size + ptr)
        cum_max.append((n_max + 1) * cum_max[level - 1] + n_max)
        cum_size.append(_enc_size(cum_max[level]))
    if root == _UNDEF:
        return

    def walk(node: int, n: int, level: int) -> Iterator[bytes]:
        if level == 0:
            body = src.signed(node, 6 + n * rec_size + 4, b"BTLF", "version 2 B-tree leaf")
            for i in range(n):
                yield body[6 + i * rec_size:6 + (i + 1) * rec_size]
            return
        total = cum_size[level - 1] if level > 1 else 0
        ptr = 8 + nrec_size + total
        body = src.signed(node, 6 + n * rec_size + (n + 1) * ptr + 4, b"BTIN",
                          "version 2 B-tree internal node")
        p = 6 + n * rec_size
        for i in range(n + 1):
            child = struct.unpack_from("<Q", body, p)[0]
            child_n = int.from_bytes(body[p + 8:p + 8 + nrec_size], "little")
            yield from walk(child, child_n, level - 1)
            if i < n:
                yield body[6 + i * rec_size:6 + (i + 1) * rec_size]
            p += ptr

    yield from walk(root, root_n, depth)


# ------------------------------------------------------------------ attributes


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
        if self._obj._file._mode == "r":
            return list(self._table())  # in the order h5py lists them
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

    def _messages(self) -> list[_Message]:
        if self._msgs is None:
            self._msgs = _messages(self._file._src, self._addr)
        return self._msgs

    def _attr_table(self) -> dict:
        if self._file._mode == "w":
            return self._wattrs
        table = getattr(self, "_rattrs", None)
        if table is None:
            self._rattrs = table = self._read_attrs()
        return table

    @_parsing
    def _read_attrs(self) -> dict:
        entries = []
        for m in self._messages():
            if m.type == 0x0C:
                entries.append((m.order, *_attribute(m.body)))
            elif m.type == 0x15:
                entries += _dense_attributes(self._file._src, m.body)
        return {name: value for _, name, value in _in_order(entries)}

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
        name = _attribute_name(body, p, name_size)
        p += _align8(name_size)
        t, _ = _parse_type(body, p)
        p += _align8(dt_size)
        shape = _dataspace(body[p:p + ds_size])
        p += _align8(ds_size)
    elif version in (2, 3):
        p = 8 if version == 2 else 9
        if body[1] & 0x03:
            raise HDF5Error("shared datatype or dataspace in an attribute is not supported")
        name = _attribute_name(body, p, name_size)
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


def _attribute_name(body: bytes, p: int, size: int) -> str:
    """An attribute's name: ``size`` counts its NUL, and the name is read
    as libhdf5 reads it, the characters before that place up to a NUL."""
    if not size:
        raise HDF5Error("attribute with an empty name field")
    return body[p:p + size - 1].split(b"\0", 1)[0].decode()


def _dense_attributes(src: _Source, body: bytes) -> list[tuple]:
    """(order, name, value) of the attributes that an attribute info
    message keeps in a fractal heap (none if it keeps none there), by
    its name-index B-tree (record type 8: heap ID, message flags,
    creation order, name hash)."""
    flags = body[1]
    heap, names = struct.unpack_from("<QQ", body, 2 + (2 if flags & 1 else 0))
    if heap == _UNDEF:
        return []
    fheap, out = src.fractal_heap(heap), []
    for rec in _btree2_records(src, names, (8,)):
        mflags, order = struct.unpack_from("<BI", rec, 8)
        _unshared(0x0C, mflags)
        out.append((order if flags & 1 else None, *_attribute(fheap.get(rec[:8]))))
    return out


# ------------------------------------------------------------------ groups


def _link(body: bytes) -> tuple[int | None, str, int]:
    """(creation order, name, object address) of a link message, a hard
    link; soft, external and user-defined links are refused by name."""
    version, flags = body[0], body[1]
    if version != 1:
        raise HDF5Error(f"link message version {version} is not supported")
    p, kind, order = 2, 0, None
    if flags & 0x08:
        kind, p = body[p], p + 1
    if flags & 0x04:
        order, p = struct.unpack_from("<Q", body, p)[0], p + 8
    if flags & 0x10:
        p += 1  # the name's character set: ASCII and UTF-8 names read alike
    width = 1 << (flags & 0x03)
    n = int.from_bytes(body[p:p + width], "little")
    p += width
    if p + n > len(body):
        raise HDF5Error("link message cut short")
    name = body[p:p + n].decode()
    p += n
    if kind == 0:
        return order, name, struct.unpack_from("<Q", body, p)[0]
    if kind == 1:
        size = struct.unpack_from("<H", body, p)[0]
        target = body[p + 2:p + 2 + size].decode(errors="replace")
        raise HDF5Error(f"soft link {name!r} (to {target!r}) is not supported")
    if kind == 64:
        raise HDF5Error(f"external link {name!r} is not supported")
    raise HDF5Error(f"user-defined link {name!r} of type {kind} is not supported")


def _dense_links(src: _Source, body: bytes) -> list[tuple]:
    """The links that a link info message keeps in a fractal heap (none
    if it keeps none there), by its name-index B-tree (record type 5:
    name hash, heap ID)."""
    flags = body[1]
    heap, names = struct.unpack_from("<QQ", body, 2 + (8 if flags & 1 else 0))
    if heap == _UNDEF:
        return []
    fheap = src.fractal_heap(heap)
    return [_link(fheap.get(rec[4:])) for rec in _btree2_records(src, names, (5,))]


class Group(_Object):
    """A group: ``g[name]``, ``name in g``, ``keys()``, ``items()``,
    ``create_group``, ``create_dataset`` and ``attrs``."""

    def __init__(self, file, addr, name, btree=None, heap=None):
        super().__init__(file, addr, name)
        self._links: dict[str, _Object] | None = None if file._mode == "r" else {}
        self._btree, self._heap = btree, heap

    # ---- read side

    @_parsing
    def _entries(self) -> dict[str, _Object]:
        if self._links is None:
            src = self._file._src
            if self._btree is None:
                msgs = self._messages()
                table = [m for m in msgs if m.type == 0x11]
                if table:
                    self._btree, self._heap = struct.unpack_from("<QQ", table[0].body)
                elif not any(m.type in (0x02, 0x06, 0x0A) for m in msgs):
                    raise HDF5Error(f"object {self.name} is not a group")
            if self._btree is not None:
                heap = _local_heap(src, self._heap)
                links = [(None, name, addr) for name, addr in _group_entries(src, self._btree, heap)]
            else:  # a new-style group: link messages, or a fractal heap of them
                links = []
                for m in self._messages():
                    if m.type == 0x06:
                        links.append(_link(m.body))
                    elif m.type == 0x02:
                        links += _dense_links(src, m.body)
            self._links = {
                name: self._file._object(addr, f"{self.name.rstrip('/')}/{name}")
                for _, name, addr in _in_order(links)}
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


def _btree_node(src: _Source, addr: int, node_type: int, key_size: int, level: int | None = None):
    """(level, [child addresses], [key bytes]) of a version 1 B-tree node
    (``level``: the one its parent's level says it has)."""
    head = src.read(addr, 24)
    if head[:4] != b"TREE":
        raise HDF5Error(f"no B-tree node at {addr}")
    ntype, found, used = head[4], head[5], struct.unpack_from("<H", head, 6)[0]
    if ntype != node_type:
        raise HDF5Error(f"B-tree node at {addr} has type {ntype}, not {node_type}")
    if level is not None and found != level:
        raise HDF5Error(f"B-tree node at {addr} has level {found}, not its parent's less 1")
    level = found
    body = src.read(addr + 24, used * (key_size + 8) + key_size)
    keys, children, p = [], [], 0
    for _ in range(used):
        keys.append(body[p:p + key_size])
        children.append(struct.unpack_from("<Q", body, p + key_size)[0])
        p += key_size + 8
    keys.append(body[p:p + key_size])
    return level, children, keys


def _group_entries(src: _Source, btree: int, heap: bytes,
                   level: int | None = None) -> Iterator[tuple[str, int]]:
    level, children, _ = _btree_node(src, btree, 0, 8, level)
    for child in children:
        if level:
            yield from _group_entries(src, child, heap, level - 1)
            continue
        head = src.read(child, 8)
        if head[:4] != b"SNOD":
            raise HDF5Error(f"no symbol-table node at {child}")
        n = struct.unpack_from("<H", head, 6)[0]
        raw = src.read(child + 8, 40 * n)
        for i in range(n):
            name_off, obj = struct.unpack_from("<QQ", raw, 40 * i)
            yield _heap_name(heap, name_off), obj


# ------------------------------------------------------------------ datasets


class _Layout(NamedTuple):
    """A dataset's storage: ``kind`` compact (``raw`` its bytes),
    contiguous (at ``addr``) or chunked (``index`` at ``addr``, chunks
    of ``chunk``; a single chunk's stored ``size`` and filter ``mask``;
    ``raw_edges``: partial edge chunks are stored unfiltered)."""

    kind: str
    addr: int = _UNDEF
    raw: bytes = b""
    index: str = ""
    chunk: tuple[int, ...] = ()
    size: int | None = None
    mask: int = 0
    raw_edges: bool = False


class _Filter(NamedTuple):
    id: int
    flags: int
    values: tuple[int, ...]
    name: str

    @property
    def label(self) -> str:
        name = _FILTERS.get(self.id) or self.name or "filter"
        return name if self.id in (1, 2, 3) else f"{name} (id {self.id})"


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

    @_parsing
    def _meta(self) -> _Layout:
        if self._layout is None:
            space, t, layout, fill, pipeline = None, None, None, None, ()
            for m in self._messages():
                if m.type == 0x01:
                    space = _dataspace(m.body, with_max=True)
                elif m.type == 0x03:
                    t = _parse_type(m.body)[0]
                elif m.type == 0x08:
                    layout = m.body
                elif m.type == 0x05:
                    fill = _fill_value(m.body)
                elif m.type == 0x0B:
                    pipeline = _pipeline(m.body)
            if space is None or t is None or layout is None:
                raise HDF5Error(f"dataset {self.name} lacks its dataspace, datatype or layout")
            for f in pipeline:
                if f.id not in (1, 2, 3):
                    raise HDF5Error(f"filter pipeline ({', '.join(g.label for g in pipeline)}) "
                                    f"on {self.name}: {f.label} is not supported")
            (self._shape, self._maxshape), self._rtype, self._fill = space, t, fill
            self._pipeline = pipeline
            self._layout = _layout(layout, self.name)
            if self._layout.kind == "contiguous":  # libhdf5's own check of its storage
                nbytes = math.prod(self._shape) * t.size
                if self._layout.size < nbytes:
                    raise HDF5Error(f"contiguous data of {self.name} holds {self._layout.size} "
                                    f"bytes, fewer than its {nbytes}")
                if self._layout.addr != _UNDEF and self._layout.addr + nbytes > self._file._src.size:
                    raise HDF5Error(f"truncated file: the data of {self.name} ends past its end")
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

    @_parsing
    def _read_into(self, r0: int, r1: int, dest: np.ndarray) -> None:
        """Rows [r0, r1) of the stored bytes into ``dest`` (C-contiguous)."""
        layout, src, t = self._meta(), self._file._src, self._rtype
        row = math.prod(self.shape[1:]) * t.size
        if not dest.nbytes:
            return
        view = memoryview(dest.reshape(-1).view(np.uint8))
        if not self.shape:
            r0, r1, row = 0, 1, t.size
        if layout.kind == "contiguous":
            if layout.addr == _UNDEF:
                self._fill_into(view)
            else:
                src.read_into(layout.addr + r0 * row, view)
        elif layout.kind == "compact":
            if len(layout.raw) < r1 * row:
                raise HDF5Error(f"compact data of {self.name} is cut short")
            view[:] = layout.raw[r0 * row:r1 * row]
        else:
            self._read_chunks(r0, r1, dest, layout)

    def _fill_into(self, view: memoryview) -> None:
        fill = self._fill or b"\0"
        view[:] = fill * (view.nbytes // len(fill))

    def _read_chunks(self, r0, r1, dest, layout: _Layout) -> None:
        """Rows [r0, r1) from the chunks that hold them: an unfiltered
        chunk in one read, straight into ``dest`` where it spans whole
        rows, else through a buffer of the chunk; a filtered chunk read
        whole and decoded (in threads when there are several), then its
        rows copied; rows of no chunk read as the fill."""
        src, size, shape, chunk = self._file._src, self._rtype.size, self.shape, layout.chunk
        cells = dest.reshape(-1).view(np.uint8).view(f"V{size}").reshape(r1 - r0, *shape[1:])
        whole_rows = tuple(chunk[1:]) == tuple(shape[1:])
        row = math.prod(shape[1:]) * size
        nbytes = math.prod(chunk) * size
        every = (1 << len(self._pipeline)) - 1
        hits, covered = [], 0
        for offsets, stored, mask, addr in self._chunk_entries(layout):
            if any(o % c or (m != _UNDEF and o >= m)
                   for o, c, m in zip(offsets, chunk, self._maxshape)):
                raise HDF5Error(f"a chunk of {self.name} at {offsets} is off the grid of its "
                                f"{chunk} chunks within {self._maxshape}")
            lo, hi = max(r0, offsets[0]), min(r1, offsets[0] + chunk[0])
            extent = [min(c, n - o) for o, c, n in zip(offsets[1:], chunk[1:], shape[1:])]
            if lo < hi and all(e > 0 for e in extent):
                partial = any(o + c > n for o, c, n in zip(offsets, chunk, shape))
                filtered = mask & every != every and not (layout.raw_edges and partial)
                hits.append((offsets, lo, hi, addr, extent, stored, mask if filtered else every))
                covered += (hi - lo) * math.prod(extent)
        if covered < cells.size:
            self._fill_into(memoryview(dest.reshape(-1).view(np.uint8)))

        def place(block: np.ndarray, offsets, lo, hi, extent) -> None:
            block = block.view(f"V{size}").reshape(chunk)
            part = tuple(slice(0, e) for e in extent)
            target = tuple(slice(o, o + e) for o, e in zip(offsets[1:], extent))
            cells[(slice(lo - r0, hi - r0), *target)] = \
                block[(slice(lo - offsets[0], hi - offsets[0]), *part)]

        def decode(hit) -> None:
            offsets, lo, hi, addr, extent, stored, mask = hit
            raw = _unfilter(src.read(addr, stored), self._pipeline, mask, self.name)
            if len(raw) != nbytes:
                raise HDF5Error(f"a chunk of {self.name} decodes to {len(raw)} bytes, "
                                f"not its {nbytes}")
            place(np.frombuffer(raw, np.uint8), offsets, lo, hi, extent)

        coded = [h for h in hits if h[6] != every]
        for offsets, lo, hi, addr, extent, _, mask in hits:
            if mask != every:
                continue
            if whole_rows:
                src.read_into(addr + (lo - offsets[0]) * row,
                              memoryview(cells[lo - r0:hi - r0].view(np.uint8).reshape(-1)))
                continue
            block = np.empty(nbytes, np.uint8)
            src.read_into(addr, memoryview(block))
            place(block, offsets, lo, hi, extent)
        if len(coded) > 1:
            with ThreadPoolExecutor(min(len(coded), _DECODE_THREADS, os.cpu_count() or 1)) as pool:
                list(pool.map(decode, coded))
        elif coded:
            decode(coded[0])

    def _chunk_entries(self, layout: _Layout) -> Iterator[tuple]:
        """(element offsets, stored bytes, filter mask, address) of every
        allocated chunk, from the dataset's chunk index."""
        src, shape, chunk = self._file._src, self.shape, layout.chunk
        nbytes = math.prod(chunk) * self._rtype.size
        if layout.index == "btree1":
            yield from _chunk_index(src, layout.addr, len(shape))
            return
        if layout.addr == _UNDEF:
            return
        if layout.index == "single":
            size = nbytes if layout.size is None else layout.size
            yield (0,) * len(shape), size, layout.mask, layout.addr
            return
        if layout.index == "btree2":
            for offsets, size, mask, addr in _btree2_chunks(src, layout.addr, len(shape), nbytes):
                yield tuple(o * c for o, c in zip(offsets, chunk)), size, mask, addr
            return
        # an index by the chunk's place in the grid of the maximum dimensions
        # (an extensible array's unlimited dimension first)
        grid = [-(-m // c) if m != _UNDEF else 0 for m, c in zip(self._maxshape, chunk)]
        order = list(range(len(shape)))
        if layout.index == "earray":
            unlimited = [i for i, m in enumerate(self._maxshape) if m == _UNDEF]
            order = unlimited + [i for i in order if i not in unlimited]
        down = [math.prod(grid[j] for j in order[k + 1:]) for k in range(len(order))]
        if layout.index == "implicit":
            n = math.prod(grid)
            addrs = layout.addr + nbytes * np.arange(n, dtype=np.uint64)
            sizes, masks = np.full(n, nbytes), np.zeros(n, np.int64)
        elif layout.index == "farray":
            addrs, sizes, masks = _fixed_array(src, layout.addr, nbytes)
        else:
            addrs, sizes, masks = _extensible_array(src, layout.addr, nbytes)
        counts = [-(-n // c) for n, c in zip(shape, chunk)]
        for scaled in np.ndindex(*counts):
            i = sum(scaled[j] * d for j, d in zip(order, down))
            if i < len(addrs) and int(addrs[i]) != _UNDEF:
                yield (tuple(s * c for s, c in zip(scaled, chunk)), int(sizes[i]), int(masks[i]),
                       int(addrs[i]))

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
    version = body[0]
    if version in (1, 2):
        if not body[3]:
            return None
        size = struct.unpack_from("<I", body, 4)[0]
        return body[8:8 + size] or None
    if version == 3:
        if not body[1] & 0x20:  # no value defined (the default, or undefined)
            return None
        size = struct.unpack_from("<I", body, 2)[0]
        return body[6:6 + size] or None
    raise HDF5Error(f"fill value message version {version} is not supported")


def _pipeline(body: bytes) -> tuple[_Filter, ...]:
    """The filters of a filter pipeline message (version 1 or 2), in the
    order they were applied."""
    version, n = body[0], body[1]
    if version not in (1, 2):
        raise HDF5Error(f"filter pipeline message version {version} is not supported")
    p, out = (8 if version == 1 else 2), []
    for _ in range(n):
        fid, = struct.unpack_from("<H", body, p)
        name = ""
        if version == 1 or fid >= 256:
            name_len, flags, n_vals = struct.unpack_from("<HHH", body, p + 2)
            p += 8
            name = body[p:p + name_len].split(b"\0", 1)[0].decode(errors="replace")
            p += _align8(name_len) if version == 1 else name_len
        else:
            flags, n_vals = struct.unpack_from("<HH", body, p + 2)
            p += 6
        values = struct.unpack_from(f"<{n_vals}I", body, p)
        p += 4 * n_vals + (4 if version == 1 and n_vals % 2 else 0)
        out.append(_Filter(fid, flags, values, name))
    return tuple(out)


def _unfilter(data: bytes, pipeline: tuple[_Filter, ...], mask: int, name: str):
    """A stored chunk's bytes with the pipeline's filters undone in
    reverse order, those whose bit ``mask`` sets skipped."""
    for i in reversed(range(len(pipeline))):
        if mask >> i & 1:
            continue
        f = pipeline[i]
        if f.id == 1:
            try:
                data = zlib.decompress(data)
            except zlib.error as err:
                raise HDF5Error(f"a deflate stream of a chunk of {name} is corrupt: {err}") from None
        elif f.id == 2:
            width = f.values[0] if f.values else 1
            raw = np.frombuffer(data, np.uint8)
            n = len(raw) // width
            if width > 1 and n > 1:
                out = np.empty_like(raw)
                out[:n * width].reshape(n, width)[:] = raw[:n * width].reshape(width, n).T
                out[n * width:] = raw[n * width:]
                data = out
        elif f.id == 3:
            if len(data) < 4:
                raise HDF5Error(f"a fletcher32 chunk of {name} is shorter than its checksum")
            body = memoryview(data)[:-4]
            stored = struct.unpack("<I", memoryview(data)[-4:])[0]
            want = struct.pack("<I", _fletcher32(body))
            # libhdf5 before 1.6.3 stored it with the bytes of each half swapped
            if stored not in struct.unpack("<2I", want + bytes(want[i] for i in (1, 0, 3, 2))):
                raise HDF5Error(f"the fletcher32 checksum of a chunk of {name} does not match")
            data = body
        else:
            raise HDF5Error(f"{f.label} filter on {name} is not supported")
    return bytes(data)


def _layout(body: bytes, name: str) -> _Layout:
    version, cls = body[0], body[1]
    if version not in (3, 4):
        raise HDF5Error(f"data layout message version {version} in {name} is not supported")
    if cls == 0:
        size = struct.unpack_from("<H", body, 2)[0]
        return _Layout("compact", raw=body[4:4 + size])
    if cls == 1:
        addr, size = struct.unpack_from("<QQ", body, 2)
        return _Layout("contiguous", addr, size=size)
    if cls == 2 and version == 3:
        rank1 = body[2]
        btree = struct.unpack_from("<Q", body, 3)[0]
        dims = struct.unpack_from(f"<{rank1}I", body, 11)
        return _Layout("chunked", btree, index="btree1", chunk=dims[:-1])
    if cls == 2:
        flags, rank1, width = body[2], body[3], body[4]
        dims = [int.from_bytes(body[5 + i * width:5 + (i + 1) * width], "little")
                for i in range(rank1)]
        p = 5 + rank1 * width
        kind, p = body[p], p + 1
        size, mask = None, 0
        if kind == 1 and flags & 0x02:
            size, mask = struct.unpack_from("<QI", body, p)
            p += 12
        elif kind not in (1, 2, 3, 4, 5):
            raise HDF5Error(f"chunk index of type {kind} in {name} is not supported")
        p += {1: 0, 2: 0, 3: 1, 4: 5, 5: 6}[kind]
        index = {1: "single", 2: "implicit", 3: "farray", 4: "earray", 5: "btree2"}[kind]
        return _Layout("chunked", struct.unpack_from("<Q", body, p)[0], index=index,
                       chunk=tuple(dims[:-1]), size=size, mask=mask, raw_edges=bool(flags & 0x01))
    raise HDF5Error(f"data layout class {cls} ({'virtual' if cls == 3 else 'unknown'}) in {name} "
                    "is not supported")


def _chunk_index(src: _Source, btree: int, rank: int, level: int | None = None):
    """(offsets, stored size, filter mask, address) of every allocated
    chunk, from the version 1 B-tree of type 1 at ``btree``."""
    if btree == _UNDEF:
        return
    key_size = 8 + 8 * (rank + 1)
    level, children, keys = _btree_node(src, btree, 1, key_size, level)
    for key, child in zip(keys, children):
        if level:
            yield from _chunk_index(src, child, rank, level - 1)
        else:
            size, mask = struct.unpack_from("<II", key)
            offsets = struct.unpack_from(f"<{rank}Q", key, 8)
            yield offsets, size, mask, child


def _chunk_records(raw: bytes, n: int, width: int, nbytes: int):
    """(addresses, stored sizes, filter masks) of ``n`` chunk records of
    ``width`` bytes: an address, and for filtered chunks its stored size
    (the bytes between) and a 4-byte filter mask."""
    rec = np.frombuffer(raw, np.uint8, n * width).reshape(n, width)
    addrs = rec[:, :8].copy().view("<u8").reshape(n)
    if width == 8:
        return addrs, np.full(n, nbytes, np.int64), np.zeros(n, np.int64)
    sizes = np.zeros(n, np.int64)
    for j in range(width - 12):
        sizes |= rec[:, 8 + j].astype(np.int64) << (8 * j)
    masks = rec[:, width - 4:].copy().view("<u4").reshape(n).astype(np.int64)
    return addrs, sizes, masks


def _btree2_chunks(src: _Source, addr: int, rank: int, nbytes: int):
    """(scaled offsets, stored size, filter mask, address) of each chunk
    of a version 2 B-tree chunk index (record type 10 or 11)."""
    for rec in _btree2_records(src, addr, (10, 11)):
        scaled = struct.unpack_from(f"<{rank}Q", rec, len(rec) - 8 * rank)
        width = len(rec) - 8 * rank
        addrs, sizes, masks = _chunk_records(rec[:width], 1, width, nbytes)
        yield scaled, int(sizes[0]), int(masks[0]), int(addrs[0])


def _paged(src: _Source, start: int, n: int, width: int, page: int, bitmap: bytes | None,
           what: str) -> bytes:
    """``n`` elements of ``width`` bytes stored in pages of ``page``
    elements from ``start``, each page with its checksum; a page whose
    bit in ``bitmap`` is clear was never written (its elements undefined)."""
    pieces = []
    for i in range(-(-n // page)):
        k = min(page, n - i * page)
        if bitmap is not None and not bitmap[i // 8] & (0x80 >> (i % 8)):
            pieces.append(b"\xff" * (k * width))
            continue
        at = start + i * (page * width + 4)
        pieces.append(_checksummed(src.read(at, k * width + 4), f"{what} page at {at}"))
    return b"".join(pieces)


def _fixed_array(src: _Source, addr: int, nbytes: int):
    """The chunk records of a fixed array index (``FAHD``, its data block
    ``FADB``, paged past 2^page_bits entries)."""
    head = src.signed(addr, 28, b"FAHD", "fixed array header")
    version, _, width, page_bits, n, block = struct.unpack_from("<BBBBQQ", head, 4)
    if version != 0:
        raise HDF5Error(f"fixed array header at {addr} has version {version}")
    if block == _UNDEF:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    page = 1 << page_bits
    what = "fixed array data block"
    if n <= page:
        raw = src.signed(block, 14 + n * width + 4, b"FADB", what)[14:]
    else:
        bitmap_len = (-(-n // page) + 7) // 8
        head = src.signed(block, 14 + bitmap_len + 4, b"FADB", what)
        raw = _paged(src, block + 14 + bitmap_len + 4, n, width, page, head[14:], what)
    return _chunk_records(raw, n, width, nbytes)


def _extensible_array(src: _Source, addr: int, nbytes: int):
    """The chunk records of an extensible array index (``EAHD``): the
    index block's (``EAIB``) own elements, then its data blocks
    (``EADB``) and those of its super blocks (``EASB``), up to the
    header's largest index set; unallocated blocks as undefined."""
    head = src.signed(addr, 72, b"EAHD", "extensible array header")
    (version, _, width, max_bits, iblock_n, dblock_min, sblock_min, page_bits, _, _, _, _, n,
     _, iblock) = struct.unpack_from("<BBBBBBBBQQQQQQQ", head, 4)
    if version != 0:
        raise HDF5Error(f"extensible array header at {addr} has version {version}")
    if iblock == _UNDEF or not n:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    n_sblocks = 1 + max_bits - (dblock_min.bit_length() - 1)
    in_iblock = 2 * (sblock_min.bit_length() - 1)  # super blocks whose data blocks the index block holds
    n_daddrs, n_saddrs = 2 * (sblock_min - 1), n_sblocks - in_iblock
    off_size, page = (max_bits + 7) // 8, 1 << page_bits
    raw = src.signed(iblock, 14 + iblock_n * width + 8 * (n_daddrs + n_saddrs) + 4, b"EAIB",
                     "extensible array index block")
    pieces = [raw[14:14 + iblock_n * width]]
    p = 14 + iblock_n * width
    daddrs = struct.unpack_from(f"<{n_daddrs}Q", raw, p)
    saddrs = struct.unpack_from(f"<{n_saddrs}Q", raw, p + 8 * n_daddrs)
    have, u, d_first = iblock_n, 0, 0
    while have < n and u < n_sblocks:
        n_dblocks, per = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblock_min
        paged = per > page
        bitmap_len = (per // page + 7) // 8 if paged else 0
        if u < in_iblock:
            dblocks, bitmaps = daddrs[d_first:d_first + n_dblocks], [None] * n_dblocks
        elif saddrs[u - in_iblock] == _UNDEF:
            dblocks, bitmaps = [_UNDEF] * n_dblocks, [None] * n_dblocks
        else:
            sraw = src.signed(saddrs[u - in_iblock], 14 + off_size + n_dblocks * (bitmap_len + 8)
                              + 4, b"EASB", "extensible array super block")
            q = 14 + off_size
            bitmaps = [sraw[q + i * bitmap_len:q + (i + 1) * bitmap_len] if paged else None
                       for i in range(n_dblocks)]
            dblocks = struct.unpack_from(f"<{n_dblocks}Q", sraw, q + n_dblocks * bitmap_len)
        for dblock, bitmap in zip(dblocks, bitmaps):
            if have >= n:
                break
            what = "extensible array data block"
            if dblock == _UNDEF:
                pieces.append(b"\xff" * (per * width))
            elif paged:
                src.signed(dblock, 14 + off_size + 4, b"EADB", what)
                pieces.append(_paged(src, dblock + 14 + off_size + 4, per, width, page, bitmap,
                                     what))
            else:
                pieces.append(src.signed(dblock, 14 + off_size + per * width + 4, b"EADB",
                                         what)[14 + off_size:])
            have += per
        d_first += n_dblocks
        u += 1
    return _chunk_records(b"".join(pieces), min(n, have), width, nbytes)


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

    @_parsing
    def _superblock(self):
        src = self._src
        if src.size < 48 or src.read(0, 8) != _SIGNATURE:
            raise HDF5Error(f"{self.filename} is not an HDF5 file (no signature at its start)")
        head = src.read(0, 24)
        version = head[8]
        if version > 3:
            raise HDF5Error(f"superblock version {version} is not supported")
        if version >= 2:  # sizes, flags, four addresses and a checksum
            raw = _checksummed(src.read(0, 48), f"superblock version {version}")
            if raw[9] != 8 or raw[10] != 8:
                raise HDF5Error(f"offsets of {raw[9]} and lengths of {raw[10]} bytes "
                                "are not supported")
            base, extension, _, root = struct.unpack_from("<QQQQ", raw, 12)
            if base != 0:
                raise HDF5Error("a superblock base address other than 0 is not supported")
            if extension != _UNDEF and any(m.type == 0x0F for m in _messages(src, extension)):
                raise HDF5Error("shared object header messages (the superblock extension's "
                                "table) are not supported")
            return root, None, None
        if src.size < 96:
            raise HDF5Error(f"truncated file: its superblock ends past its end ({src.size})")
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
            types = {m.type for m in msgs}
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
                    if obj._addr in self._paths:  # a group seen on another path
                        continue
                    self._paths[obj._addr] = obj.name
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
