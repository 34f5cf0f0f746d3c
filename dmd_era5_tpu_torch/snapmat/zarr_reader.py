"""Minimal Zarr-v2 reader: the ERA5 ingest path.

The port's copy of ``dmd_era5_tpu/snapmat/zarr_reader.py`` (numpy, zlib
and gzip; no zarr, xarray or dask), which decodes every chunk exactly as
that module does, so the two packages read the same bytes into the same
arrays.  It implements the subset of the Zarr v2 spec the pipeline
needs, on top of plain bytes storage:

- metadata: consolidated ``.zmetadata`` or per-node ``.zgroup`` /
  ``.zarray`` / ``.zattrs`` JSON;
- storage: local directories and any fsspec URL (``gs://`` through
  gcsfs); ``fsspec`` is imported only when such a URL is opened, and a
  machine without it gets an error that names the package;
- codecs: raw, zlib, gzip, zstd, and the blosc1 container (byte
  shuffle + memcpy/zlib/zstd/LZ4 internals, the LZ4 block format decoded
  in pure Python, which is byte-serial on overlapping matches);
- indexing: orthogonal selection (ints / slices / 1-D integer arrays)
  with chunk-level pushdown: only the chunks covering the requested
  region are fetched and decoded, which is what makes a time/level
  slice of a multi-TB store cheap;
- CF time decoding (``<unit> since <epoch>``) for the time coordinate.

A blosc frame is read as c-blosc 1.x writes it: block by block, each
block byte-shuffled on its own and, unless header flag ``0x10`` is set,
split into ``typesize`` streams, each behind its own size word; a memcpy
frame holds the chunk's bytes as they are.  Here the port departs from
the JAX package's reader, which unshuffles the whole chunk at once and
reads one stream a block, and so misreads a frame of several shuffled
blocks or of split streams (every real ARCO-ERA5 chunk; ROADMAP Queue 3,
R8, pinned by ``tests/test_torch_zarr.py``).  Every other codec decodes
the same bytes in both packages.

It is a *reader*: the pipeline never writes Zarr.  ``write_zarr_array``
below exists for tests and local fixtures only.
"""

from __future__ import annotations

import gzip
import json
import struct
import zlib
from pathlib import Path
from typing import Any, Iterator, Mapping

import numpy as np

__all__ = [
    "ZarrArray",
    "ZarrGroup",
    "open_zarr_group",
    "decode_cf_time",
    "write_zarr_array",
]


# --------------------------------------------------------------- storage


class _LocalStore:
    """Key -> bytes view over a local Zarr directory."""

    def __init__(self, root: str | Path):
        self.root = Path(root)

    def get(self, key: str) -> bytes | None:
        path = self.root / key
        try:
            return path.read_bytes()
        except (FileNotFoundError, IsADirectoryError, NotADirectoryError):
            return None

    def list_prefix(self, prefix: str = "") -> list[str]:
        base = self.root / prefix if prefix else self.root
        if not base.is_dir():
            return []
        return sorted(p.name for p in base.iterdir())


class _FsspecStore:
    """Key -> bytes view over any fsspec URL (gs:// via gcsfs)."""

    def __init__(self, url: str):
        try:
            import fsspec
        except ImportError as err:
            raise ImportError(
                f"reading the Zarr store {url!r} needs the fsspec package (and gcsfs "
                "for gs://), which is not installed; copy the store to a local "
                "directory and point source_path at it"
            ) from err

        self.mapper = fsspec.get_mapper(url)

    def get(self, key: str) -> bytes | None:
        try:
            return self.mapper[key]
        except KeyError:
            return None

    def list_prefix(self, prefix: str = "") -> list[str]:
        names = set()
        plen = len(prefix) + 1 if prefix else 0
        for key in self.mapper:
            if prefix and not key.startswith(prefix + "/"):
                continue
            names.add(key[plen:].split("/")[0])
        return sorted(names)


def _open_store(url: str | Path):
    if isinstance(url, str) and "://" in url:
        return _FsspecStore(url)
    return _LocalStore(url)


# ---------------------------------------------------------------- codecs


def _lz4_block_decompress(src: bytes, dest_size: int) -> bytes:
    """Pure-Python LZ4 *block* format decoder (no frame header).

    The format is a sequence of [token][literals][match] sequences:
    token high nibble = literal length (15 => extension bytes follow),
    token low nibble = match length - 4, then a 2-byte little-endian
    match offset.  Used for blosc chunks with the LZ4 internal codec.
    """
    dst = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if lit_len:
            dst += src[i : i + lit_len]
            i += lit_len
        if i >= n:  # last sequence has no match part
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("Corrupt LZ4 block: zero match offset")
        match_len = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        start = len(dst) - offset
        if start < 0:
            raise ValueError("Corrupt LZ4 block: offset before start")
        if match_len <= offset:  # the source lies wholly before the copy
            dst += dst[start : start + match_len]
        else:  # overlapping copies are byte-serial by definition
            for j in range(match_len):
                dst.append(dst[start + j])
    if len(dst) != dest_size:
        raise ValueError(
            f"LZ4 block decoded to {len(dst)} bytes, expected {dest_size}"
        )
    return bytes(dst)


_BLOSC_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
# c-blosc 1.x splits a block into typesize streams only for typesize <=
# _BLOSC_MAX_SPLITS and at least _BLOSC_MIN_SPLIT elements a block (blosc.h,
# MAX_SPLITS and MIN_BUFFERSIZE), and never its last, ragged block.
_BLOSC_MAX_SPLITS = 16
_BLOSC_MIN_SPLIT = 128


def _blosc_stream(codec: str, payload: bytes, size: int) -> bytes:
    """One compressed stream of a blosc block, decoded to ``size`` bytes."""
    if codec == "zlib":
        out = zlib.decompress(payload)
    elif codec == "zstd":
        import zstandard

        out = zstandard.ZstdDecompressor().decompress(payload, max_output_size=size)
    elif codec == "lz4":
        return _lz4_block_decompress(payload, size)
    else:
        raise ValueError(f"blosc internal codec {codec!r} not supported by this reader")
    if len(out) != size:
        raise ValueError(f"blosc {codec} stream decoded to {len(out)} bytes, expected {size}")
    return out


def _byte_unshuffle(raw: bytes, typesize: int) -> bytes:
    """Invert blosc's byte shuffle of one block: the (typesize, n_elems)
    planes interleaved back into elements.  The bytes past the last whole
    element stay where they are, as c-blosc leaves them."""
    n = len(raw) // typesize
    if typesize <= 1 or n == 0:
        return raw
    whole = np.frombuffer(raw, dtype=np.uint8, count=n * typesize)
    return whole.reshape(typesize, n).T.tobytes() + raw[n * typesize:]


def _blosc_decompress(data: bytes) -> bytes:
    """Decode a blosc1 frame to the chunk's bytes.

    Header layout (c-blosc blosc.h): version, versionlz, flags, typesize,
    then uint32 nbytes / blocksize / cbytes; flags 0x1 byte shuffle, 0x2
    memcpy, 0x4 bit shuffle, 0x10 "blocks not split", bits 5-7 the
    internal codec.  A memcpy frame holds the chunk raw after the header,
    unshuffled whatever its flags say.  Otherwise a table of int32 block
    starts follows, and each block (``blocksize`` bytes, the last one
    ragged) is ``nsplits`` streams of an int32 size word and the stream;
    a size word equal to the stream's decoded length marks it stored raw.
    Each block is unshuffled on its own.
    """
    if len(data) < 16:
        raise ValueError("Truncated blosc header")
    flags, typesize = data[2], data[3]
    nbytes, blocksize, _cbytes = struct.unpack_from("<III", data, 4)
    if flags & 0x4:
        raise ValueError("blosc bit-shuffle not supported by this reader")
    if flags & 0x2:
        return data[16 : 16 + nbytes]
    shuffled = bool(flags & 0x1) and typesize > 1
    splittable = not flags & 0x10 and typesize <= _BLOSC_MAX_SPLITS
    codec = _BLOSC_CODECS.get((flags >> 5) & 0x7, "?")
    n_blocks = -(-nbytes // blocksize)
    bstarts = struct.unpack_from(f"<{n_blocks}i", data, 16)
    out = bytearray(nbytes)
    for b, pos in enumerate(bstarts):
        bsize = min(blocksize, nbytes - b * blocksize)
        split = splittable and bsize == blocksize and bsize // typesize >= _BLOSC_MIN_SPLIT
        nsplits = typesize if split else 1
        neblock = bsize // nsplits
        streams = []
        for _ in range(nsplits):
            (csize,) = struct.unpack_from("<i", data, pos)
            payload = data[pos + 4 : pos + 4 + csize]
            pos += 4 + csize
            streams.append(payload if csize == neblock else _blosc_stream(codec, payload, neblock))
        block = b"".join(streams)
        if shuffled:
            block = _byte_unshuffle(block, typesize)
        out[b * blocksize : b * blocksize + bsize] = block
    return bytes(out)


def _decode_chunk(data: bytes, compressor: Mapping[str, Any] | None) -> bytes:
    if compressor is None:
        return data
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.decompress(data)
    if cid == "gzip":
        return gzip.decompress(data)
    if cid == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=1 << 31
        )
    if cid == "blosc":
        return _blosc_decompress(data)
    raise ValueError(f"Unsupported Zarr compressor: {cid!r}")


# ---------------------------------------------------------------- arrays


def _node_key(path: str, name: str) -> str:
    return f"{path}/{name}" if path else name


class ZarrArray:
    """One Zarr v2 array: lazy, chunk-pushdown orthogonal indexing."""

    def __init__(
        self,
        store,
        path: str,
        meta: Mapping[str, Any],
        attrs: Mapping[str, Any] | None = None,
    ):
        if meta.get("zarr_format") != 2:
            raise ValueError(
                f"Only Zarr format 2 is supported, got {meta.get('zarr_format')}"
            )
        self.store = store
        self.path = path
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value")
        self.order = meta.get("order", "C")
        self.compressor = meta.get("compressor")
        self.sep = meta.get("dimension_separator", ".")
        filters = meta.get("filters")
        if filters:
            raise ValueError(
                f"Zarr filters not supported by this reader: {filters}"
            )
        self.attrs = dict(attrs or {})

    # -- metadata ------------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dims(self) -> tuple[str, ...] | None:
        """xarray's dimension-name convention, if present."""
        names = self.attrs.get("_ARRAY_DIMENSIONS")
        return tuple(names) if names else None

    def __repr__(self) -> str:
        return (
            f"ZarrArray(path={self.path!r}, shape={self.shape}, "
            f"chunks={self.chunks}, dtype={self.dtype})"
        )

    # -- chunk access --------------------------------------------------

    def _chunk_key(self, idx: tuple[int, ...]) -> str:
        name = self.sep.join(str(i) for i in idx) if idx else "0"
        return _node_key(self.path, name)

    def _read_chunk(self, idx: tuple[int, ...]) -> np.ndarray:
        data = self.store.get(self._chunk_key(idx))
        if data is None:
            fill = 0 if self.fill_value is None else self.fill_value
            return np.full(self.chunks, fill, dtype=self.dtype)
        raw = _decode_chunk(bytes(data), self.compressor)
        arr = np.frombuffer(raw, dtype=self.dtype)
        if self.order == "F":
            return arr.reshape(tuple(reversed(self.chunks))).T
        return arr.reshape(self.chunks)

    def read_region(
        self, starts: tuple[int, ...], stops: tuple[int, ...]
    ) -> np.ndarray:
        """Materialize [starts, stops) touching only the covering chunks."""
        starts = tuple(int(s) for s in starts)
        stops = tuple(int(s) for s in stops)
        out_shape = tuple(e - s for s, e in zip(starts, stops))
        out = np.empty(out_shape, dtype=self.dtype)
        c_lo = tuple(s // c for s, c in zip(starts, self.chunks))
        c_hi = tuple(-(-e // c) if e > s else s // c
                     for s, e, c in zip(starts, stops, self.chunks))

        def rec(dim: int, cidx: list[int]):
            if dim == self.ndim:
                chunk = self._read_chunk(tuple(cidx))
                src, dst = [], []
                for d, ci in enumerate(cidx):
                    base = ci * self.chunks[d]
                    lo = max(starts[d], base)
                    hi = min(stops[d], base + self.chunks[d], self.shape[d])
                    src.append(slice(lo - base, hi - base))
                    dst.append(slice(lo - starts[d], hi - starts[d]))
                out[tuple(dst)] = chunk[tuple(src)]
                return
            for ci in range(c_lo[dim], c_hi[dim]):
                rec(dim + 1, cidx + [ci])

        if all(e > s for s, e in zip(starts, stops)):
            rec(0, [])
        return out

    # -- orthogonal indexing -------------------------------------------

    def __getitem__(self, selection) -> np.ndarray:
        if not isinstance(selection, tuple):
            selection = (selection,)
        if len(selection) > self.ndim:
            raise IndexError(
                f"Too many indices ({len(selection)}) for shape {self.shape}"
            )
        selection = selection + (slice(None),) * (self.ndim - len(selection))

        starts, stops, post, squeeze = [], [], [], []
        for d, (sel, n) in enumerate(zip(selection, self.shape)):
            if isinstance(sel, (int, np.integer)):
                i = int(sel) % n if sel < 0 else int(sel)
                if not 0 <= i < n:
                    raise IndexError(f"Index {sel} out of range for dim {d}")
                starts.append(i)
                stops.append(i + 1)
                post.append(slice(None))
                squeeze.append(d)
            elif isinstance(sel, slice):
                lo, hi, step = sel.indices(n)
                if step <= 0:
                    raise IndexError("Negative slice steps not supported")
                starts.append(lo)
                stops.append(max(lo, hi))
                post.append(slice(None, None, step) if step > 1 else slice(None))
            else:
                idx = np.asarray(sel)
                if idx.dtype == bool:
                    idx = np.nonzero(idx)[0]
                if idx.size == 0:
                    starts.append(0)
                    stops.append(0)
                    post.append(slice(None))
                    continue
                idx = np.where(idx < 0, idx + n, idx).astype(np.int64)
                lo, hi = int(idx.min()), int(idx.max()) + 1
                starts.append(lo)
                stops.append(hi)
                post.append(idx - lo)

        region = self.read_region(tuple(starts), tuple(stops))
        # apply per-axis sub-selection (np.ix_-style orthogonal semantics)
        for d, p in enumerate(post):
            if isinstance(p, slice) and p == slice(None):
                continue
            region = region[(slice(None),) * d + (p,)]
        if squeeze:
            region = region.reshape(
                tuple(
                    s
                    for d, s in enumerate(region.shape)
                    if d not in squeeze
                )
            )
        return region

    def iter_axis_blocks(
        self, axis: int = 0, lo: int = 0, hi: int | None = None
    ) -> Iterator[tuple[int, int]]:
        """Chunk-aligned [lo, hi) block ranges along one axis.

        The streaming-ingest granularity: each yielded block decodes each
        covering chunk exactly once.
        """
        hi = self.shape[axis] if hi is None else hi
        step = self.chunks[axis]
        b0 = lo
        while b0 < hi:
            b1 = min(((b0 // step) + 1) * step, hi)
            yield b0, b1
            b0 = b1


# ---------------------------------------------------------------- groups


class ZarrGroup:
    """A Zarr v2 group: named arrays + attributes."""

    def __init__(self, store, path: str = "", consolidated: dict | None = None):
        self.store = store
        self.path = path
        self._consolidated = consolidated
        self.attrs = self._load_json(".zattrs") or {}

    def _load_json(self, name: str) -> dict | None:
        data = self.store.get(_node_key(self.path, name))
        return json.loads(data) if data is not None else None

    def array_keys(self) -> list[str]:
        if self._consolidated is not None:
            prefix = f"{self.path}/" if self.path else ""
            keys = []
            for key in self._consolidated:
                if key.startswith(prefix) and key.endswith("/.zarray"):
                    rest = key[len(prefix) : -len("/.zarray")]
                    if "/" not in rest:
                        keys.append(rest)
            return sorted(keys)
        names = []
        for name in self.store.list_prefix(self.path):
            if self.store.get(_node_key(_node_key(self.path, name), ".zarray")):
                names.append(name)
        return sorted(names)

    def __contains__(self, name: str) -> bool:
        return name in self.array_keys()

    def __getitem__(self, name: str) -> ZarrArray:
        node = _node_key(self.path, name)
        if self._consolidated is not None:
            meta = self._consolidated.get(f"{node}/.zarray")
            attrs = self._consolidated.get(f"{node}/.zattrs") or {}
        else:
            raw = self.store.get(_node_key(node, ".zarray"))
            meta = json.loads(raw) if raw is not None else None
            raw_attrs = self.store.get(_node_key(node, ".zattrs"))
            attrs = json.loads(raw_attrs) if raw_attrs is not None else {}
        if meta is None:
            raise KeyError(f"No Zarr array at {node!r}")
        return ZarrArray(self.store, node, meta, attrs)


def open_zarr_group(url: str | Path) -> ZarrGroup:
    """Open a Zarr v2 group from a local path or fsspec URL (gs://...).

    Prefers consolidated metadata (``.zmetadata``) — one storage read
    for the whole hierarchy, the layout ARCO-ERA5 publishes — falling
    back to per-node JSON.
    """
    store = _open_store(url)
    raw = store.get(".zmetadata")
    consolidated = None
    if raw is not None:
        doc = json.loads(raw)
        consolidated = doc.get("metadata", doc)
    group = ZarrGroup(store, "", consolidated)
    if consolidated is not None and ".zattrs" in consolidated:
        group.attrs = consolidated[".zattrs"]
    return group


# ---------------------------------------------------------------- CF time


_CF_UNITS_NS = {
    "nanosecond": 1,
    "microsecond": 1_000,
    "millisecond": 1_000_000,
    "second": 1_000_000_000,
    "minute": 60 * 1_000_000_000,
    "hour": 3_600 * 1_000_000_000,
    "day": 86_400 * 1_000_000_000,
}


def decode_cf_time(values: np.ndarray, units: str) -> np.ndarray:
    """Decode CF-convention time ("<unit>s since <epoch>") to datetime64[ns].

    The ARCO-ERA5 time coordinate stores integer offsets with a units
    attribute; xarray normally decodes this — here it is explicit.
    """
    try:
        unit_part, _, epoch_part = units.partition(" since ")
    except AttributeError as err:
        raise ValueError(f"Unparseable CF time units: {units!r}") from err
    unit = unit_part.strip().lower().rstrip("s")
    if unit not in _CF_UNITS_NS:
        raise ValueError(f"Unsupported CF time unit: {unit_part!r}")
    epoch = np.datetime64(epoch_part.strip().replace(" ", "T"), "ns")
    scale = _CF_UNITS_NS[unit]
    offsets = np.asarray(values)
    if offsets.dtype.kind == "f":
        ns = (offsets * scale).round().astype("int64")
    else:
        ns = offsets.astype("int64") * scale
    return epoch + ns.astype("timedelta64[ns]")


# ------------------------------------------------------- fixture writer


def write_zarr_array(
    root: str | Path,
    name: str,
    data: np.ndarray,
    chunks: tuple[int, ...] | None = None,
    dims: tuple[str, ...] | None = None,
    attrs: dict | None = None,
    compressor: str | None = "zlib",
    dimension_separator: str = ".",
) -> None:
    """Write one array in Zarr v2 layout (tests/local fixtures only)."""
    root = Path(root)
    node = root / name
    node.mkdir(parents=True, exist_ok=True)
    if not (root / ".zgroup").exists():
        (root / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
    chunks = chunks or data.shape
    comp_meta = {"id": compressor, "level": 1} if compressor else None
    meta = {
        "zarr_format": 2,
        "shape": list(data.shape),
        "chunks": list(chunks),
        "dtype": data.dtype.str,
        "compressor": comp_meta,
        "fill_value": None,
        "order": "C",
        "filters": None,
        "dimension_separator": dimension_separator,
    }
    (node / ".zarray").write_text(json.dumps(meta))
    zattrs = dict(attrs or {})
    if dims:
        zattrs["_ARRAY_DIMENSIONS"] = list(dims)
    (node / ".zattrs").write_text(json.dumps(zattrs))

    grid = [range(-(-s // c)) for s, c in zip(data.shape, chunks)]

    def rec(dim: int, cidx: list[int]):
        if dim == data.ndim:
            sel = tuple(
                slice(ci * c, min((ci + 1) * c, s))
                for ci, c, s in zip(cidx, chunks, data.shape)
            )
            block = data[sel]
            pad = [
                (0, c - bs) for c, bs in zip(chunks, block.shape)
            ]
            if any(p[1] for p in pad):
                block = np.pad(block, pad)
            raw = np.ascontiguousarray(block).tobytes()
            if compressor == "zlib":
                raw = zlib.compress(raw, 1)
            elif compressor == "gzip":
                raw = gzip.compress(raw, 1)
            elif compressor is not None:
                raise ValueError(f"Fixture writer supports zlib/gzip, not {compressor}")
            key = dimension_separator.join(str(i) for i in cidx)
            target = node / key
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_bytes(raw)
            return
        for ci in grid[dim]:
            rec(dim + 1, cidx + [ci])

    rec(0, [])
