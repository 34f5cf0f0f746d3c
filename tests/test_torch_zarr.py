"""Parity of the port's Zarr ingest with the JAX package's.

tests/test_19_zarr.py case by case through both packages: stores written
by either package's ``write_zarr_array`` and read by either reader, the
codecs, slice pushdown, the committed ARCO-ERA5 fixtures, the download
stage against the JAX ``download_era5_data``, and ``zarr_to_packed`` to
HDF5 (read by either package) and to ``.npy``.  Readers and packed files
agree bit for bit.  Then config.ini's three stages on a local Zarr
store in the port, and the blosc frames as c-blosc 1.x lays them out,
which the port decodes and the JAX reader misreads (ROADMAP Queue 3, R8;
pinned).  No case opens a remote URL.
"""

from __future__ import annotations

import gzip
import json
import math
import struct
import sys
import zlib
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest

from dmd_era5_tpu.snapmat import era5_zarr as jzarr
from dmd_era5_tpu.snapmat import loader as jloader
from dmd_era5_tpu.snapmat import zarr_reader as jreader
from dmd_era5_tpu_torch.core import config_parser, config_reader
from dmd_era5_tpu_torch.snapmat import era5_zarr as tzarr
from dmd_era5_tpu_torch.snapmat import loader as tloader
from dmd_era5_tpu_torch.snapmat import zarr_reader as treader

READERS = {"jax": jreader, "port": treader}
FIXTURES = Path(__file__).resolve().parent / "fixtures"
CONFIG = Path(__file__).resolve().parents[1] / "config.ini"


def _when(stamp: str) -> datetime:
    return np.datetime64(stamp).astype("datetime64[s]").item()


def _hours_since_1900(times: np.ndarray) -> np.ndarray:
    epoch = np.datetime64("1900-01-01T00:00:00", "ns")
    return ((times.astype("datetime64[ns]") - epoch) / np.timedelta64(1, "h")).astype(np.int64)


def make_era5_zarr_fixture(root: Path, writer: str = "port", n_time: int = 30,
                           levels=(850, 1000), n_lat: int = 9, n_lon: int = 10,
                           variables=("temperature", "u_component_of_wind"),
                           compressor: str | None = "zlib", time_chunk: int = 8,
                           seed: int = 0, start: str = "2019-01-01T00", data=None) -> dict:
    """test_19's hand-written ERA5-like store (CF time, chunked), written
    by ``writer``'s ``write_zarr_array``; ``data``: the fields to store
    (by variable), else standard normal draws."""
    write = READERS[writer].write_zarr_array
    rng = np.random.default_rng(seed)
    times = np.datetime64(start, "ns") + np.arange(n_time) * np.timedelta64(1, "h")
    lats = np.linspace(90, -90, n_lat)
    lons = np.linspace(-180, 175, n_lon)
    lev = np.asarray(levels, dtype=np.int64)
    write(root, "time", _hours_since_1900(times), dims=("time",),
          attrs={"units": "hours since 1900-01-01T00:00:00"}, compressor=None)
    write(root, "level", lev, dims=("level",), compressor=None)
    write(root, "latitude", lats, dims=("latitude",), compressor=None)
    write(root, "longitude", lons, dims=("longitude",), compressor=None)
    fields = {}
    for var in variables:
        arr = (data or {}).get(var)
        if arr is None:
            arr = rng.standard_normal((n_time, len(lev), n_lat, n_lon)).astype(np.float32)
        write(root, var, arr, chunks=(time_chunk, 1, n_lat, n_lon),
              dims=("time", "level", "latitude", "longitude"), compressor=compressor)
        fields[var] = arr
    return {"times": times, "levels": lev, "lats": lats, "lons": lons, "data": fields}


@pytest.fixture(params=["jax", "port"])
def era5_zarr(request, tmp_path) -> tuple[Path, dict]:
    """The store, written by each package's writer in turn."""
    root = tmp_path / "era5.zarr"
    return root, make_era5_zarr_fixture(root, request.param)


def _tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


# --------------------------------------------------------------- reader


@pytest.mark.parametrize("compressor", [None, "zlib", "gzip"])
def test_both_writers_write_the_same_store(tmp_path, compressor):
    """write_zarr_array of either package gives the same files, byte for
    byte (gzip aside, whose header carries the time): same metadata, same
    chunk keys, same chunk bytes."""
    for writer in READERS:
        make_era5_zarr_fixture(tmp_path / writer, writer, compressor=compressor, n_time=12)
    jax_files, port_files = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert sorted(jax_files) == sorted(port_files)
    for key, raw in jax_files.items():
        if raw != port_files[key]:  # a gzip member's header stamps the time
            assert compressor == "gzip", key
            assert gzip.decompress(raw) == gzip.decompress(port_files[key]), key


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_roundtrip_full(era5_zarr, reader):
    root, info = era5_zarr
    group = READERS[reader].open_zarr_group(root)
    assert set(group.array_keys()) >= {"temperature", "time", "level"}
    arr = group["temperature"]
    assert arr.shape == info["data"]["temperature"].shape
    np.testing.assert_array_equal(arr[:], info["data"]["temperature"])


def test_orthogonal_selection(era5_zarr):
    root, info = era5_zarr
    arr = treader.open_zarr_group(root)["temperature"]
    arr_j = jreader.open_zarr_group(root)["temperature"]
    ref = info["data"]["temperature"]
    for sel, want in (
        ((slice(3, 17), np.asarray([1]), slice(2, 5)), ref[3:17, [1], 2:5]),
        (5, ref[5]),  # an int index squeezes the axis
        ((slice(None, None, 3), 0), ref[::3, 0]),  # a strided slice
        ((slice(2, 9), np.asarray([True, False]), -1), ref[2:9, [0], -1]),
    ):
        got = arr[sel]
        np.testing.assert_array_equal(got, want)
        assert got.tobytes() == arr_j[sel].tobytes()


def test_chunk_pushdown_reads_only_covering_chunks(era5_zarr):
    root, _ = era5_zarr
    arr = treader.open_zarr_group(root)["temperature"]
    reads: list[str] = []
    orig = arr.store.get

    def spy(key):
        if not key.endswith((".zarray", ".zattrs", ".zgroup")):
            reads.append(key)
        return orig(key)

    arr.store.get = spy
    arr[0:8, 0]  # one time chunk x one level chunk
    assert reads == ["temperature/0.0.0.0"]
    reads.clear()
    arr[7:17, 1]  # three time chunks of the second level
    assert reads == [f"temperature/{t}.1.0.0" for t in range(3)]


def test_iter_axis_blocks_is_chunk_aligned(era5_zarr):
    root, _ = era5_zarr
    arr = treader.open_zarr_group(root)["temperature"]
    arr_j = jreader.open_zarr_group(root)["temperature"]
    for lo, hi in ((0, None), (5, 21), (8, 16), (29, 30)):
        got = list(arr.iter_axis_blocks(0, lo, hi))
        assert got == list(arr_j.iter_axis_blocks(0, lo, hi))
        assert got[0][0] == lo and got[-1][1] == (hi or 30)
        assert all(b0 // 8 == (b1 - 1) // 8 for b0, b1 in got)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_missing_chunk_gives_fill_value(tmp_path, writer):
    root = tmp_path / "z"
    READERS[writer].write_zarr_array(root, "a", np.arange(12, dtype=np.float32).reshape(3, 4),
                                     chunks=(2, 4))
    (root / "a" / "1.0").unlink()
    out = treader.open_zarr_group(root)["a"][:]
    np.testing.assert_array_equal(out[:2], np.arange(8).reshape(2, 4))
    np.testing.assert_array_equal(out[2], 0)
    assert out.tobytes() == jreader.open_zarr_group(root)["a"][:].tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("comp", [None, "zlib", "gzip"])
def test_gzip_and_raw_codecs(tmp_path, writer, comp):
    data = np.arange(40, dtype=np.int32).reshape(5, 8)
    root = tmp_path / f"z_{comp}"
    READERS[writer].write_zarr_array(root, "a", data, chunks=(2, 8), compressor=comp)
    for reader in READERS.values():
        np.testing.assert_array_equal(reader.open_zarr_group(root)["a"][:], data)


def test_writer_refuses_other_codecs(tmp_path):
    with pytest.raises(ValueError, match="zlib/gzip"):
        treader.write_zarr_array(tmp_path / "z", "a", np.zeros(4), compressor="blosc")


def test_consolidated_metadata(tmp_path):
    root = tmp_path / "z"
    data = np.arange(6, dtype=np.float64).reshape(2, 3)
    treader.write_zarr_array(root, "a", data, dims=("x", "y"))
    meta = {
        "zarr_format": 2,
        "metadata": {
            ".zgroup": {"zarr_format": 2},
            ".zattrs": {"title": "consolidated"},
            "a/.zarray": json.loads((root / "a" / ".zarray").read_text()),
            "a/.zattrs": json.loads((root / "a" / ".zattrs").read_text()),
        },
    }
    (root / ".zmetadata").write_text(json.dumps(meta))
    group = treader.open_zarr_group(root)
    assert group._consolidated is not None
    assert group.array_keys() == ["a"] and "a" in group
    assert group.attrs == {"title": "consolidated"}
    arr = group["a"]
    assert arr.dims == ("x", "y")
    np.testing.assert_array_equal(arr[:], data)
    with pytest.raises(KeyError, match="No Zarr array"):
        group["b"]


def test_dimension_separator_slash(tmp_path):
    root = tmp_path / "z"
    data = np.arange(16, dtype=np.float32).reshape(4, 4)
    treader.write_zarr_array(root, "a", data, chunks=(2, 2), dimension_separator="/")
    assert (root / "a" / "0" / "1").exists()
    for reader in READERS.values():
        np.testing.assert_array_equal(reader.open_zarr_group(root)["a"][:], data)


def test_cf_time_decode():
    units = "hours since 1900-01-01T00:00:00"
    vals = np.asarray([0, 24, 25])
    got = treader.decode_cf_time(vals, units)
    assert got[0] == np.datetime64("1900-01-01T00", "ns")
    assert got[1] == np.datetime64("1900-01-02T00", "ns")
    # float offsets (some stores) round correctly
    np.testing.assert_array_equal(got, treader.decode_cf_time(vals.astype(np.float64), units))
    for u in (units, "days since 1959-01-01", "minutes since 2000-01-01 06:00:00"):
        np.testing.assert_array_equal(treader.decode_cf_time(vals, u),
                                      jreader.decode_cf_time(vals, u))
    with pytest.raises(ValueError, match="Unsupported CF time unit"):
        treader.decode_cf_time(vals, "fortnights since 1900-01-01")


def test_rejects_v3_and_filters():
    store_meta = {"zarr_format": 3, "shape": [2], "chunks": [2], "dtype": "<f4"}
    with pytest.raises(ValueError, match="format 2"):
        treader.ZarrArray(None, "a", store_meta)
    meta2 = {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f4",
             "filters": [{"id": "delta"}]}
    with pytest.raises(ValueError, match="filters"):
        treader.ZarrArray(None, "a", meta2)


def test_gs_url_without_fsspec_names_the_package(monkeypatch):
    """fsspec is imported only when a URL is opened; without it the error
    names the package (nothing is fetched)."""
    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(ImportError, match="fsspec"):
        treader.open_zarr_group("gs://bucket/store.zarr")


# ----------------------------------------------------------- blosc / lz4


def _lz4_literals(raw: bytes) -> bytes:
    """Minimal valid LZ4 block: one all-literal sequence."""
    n = len(raw)
    out = bytearray()
    if n < 15:
        out.append(n << 4)
    else:
        out.append(0xF0)
        rest = n - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    return bytes(out + raw)


def _lz4_extension(n: int) -> bytes:
    out = bytearray()
    while n >= 255:
        out.append(255)
        n -= 255
    return bytes(out + bytes([n]))


def test_lz4_literals():
    raw = bytes(range(256)) * 3
    enc = _lz4_literals(raw)
    assert treader._lz4_block_decompress(enc, len(raw)) == raw
    assert jreader._lz4_block_decompress(enc, len(raw)) == raw


def test_lz4_match_sequence():
    # "abcd" then a match copying 8 bytes from offset 4 (overlapping:
    # repeats abcd twice), then literals "XY" as the tail
    enc = bytes([0x44]) + b"abcd" + struct.pack("<H", 4) + bytes([0x20]) + b"XY"
    assert treader._lz4_block_decompress(enc, 14) == b"abcd" + b"abcdabcd" + b"XY"


def test_lz4_matches_decode_as_the_jax_decoder():
    """Random sequences of literals and matches (overlapping, whose copy
    is byte-serial, and not overlapping, which the port copies as one
    slice; short and extended lengths) decode to the same bytes in both."""
    rng = np.random.default_rng(4)
    enc, plain = bytearray(), bytearray()
    for i in range(60):
        lit = rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
        if i == 59:
            enc += _lz4_literals(lit)
            plain += lit
            break
        offset = int(rng.integers(1, min(len(plain) + len(lit), 300) + 1))
        match = int(rng.integers(4, 300)) if i % 3 else offset  # match == offset at the edge
        match = max(match, 4)
        token = (min(len(lit), 15) << 4) | min(match - 4, 15)
        enc.append(token)
        if len(lit) >= 15:
            enc += _lz4_extension(len(lit) - 15)
        enc += lit + struct.pack("<H", offset)
        if match - 4 >= 15:
            enc += _lz4_extension(match - 4 - 15)
        plain += lit
        for _ in range(match):
            plain.append(plain[-offset])
    got = treader._lz4_block_decompress(bytes(enc), len(plain))
    assert got == bytes(plain) == jreader._lz4_block_decompress(bytes(enc), len(plain))


def test_lz4_corrupt_blocks_raise():
    with pytest.raises(ValueError, match="zero match offset"):
        treader._lz4_block_decompress(bytes([0x10]) + b"a" + b"\x00\x00", 5)
    with pytest.raises(ValueError, match="offset before start"):
        treader._lz4_block_decompress(bytes([0x10]) + b"a" + b"\x05\x00", 5)
    with pytest.raises(ValueError, match="expected 9"):
        treader._lz4_block_decompress(_lz4_literals(b"abc"), 9)


def _make_blosc(raw: bytes, typesize: int, codec: int, shuffle: bool) -> bytes:
    """Hand-build a single-block blosc1 chunk (test_19's encoder) of one
    stream: flag 0x10 says the block is not split."""
    nbytes = len(raw)
    body = raw
    if shuffle:
        body = np.frombuffer(raw, np.uint8).reshape(-1, typesize).T.tobytes()
    flags = (0x1 if shuffle else 0) | 0x10 | (codec << 5)
    if codec == 3:
        comp = zlib.compress(body)
    elif codec == 1:
        comp = _lz4_literals(body)
    else:
        raise AssertionError("zlib and lz4 blocks only")
    header = struct.pack("<BBBBIII", 2, 1, flags, typesize, nbytes, nbytes, 16 + 8 + len(comp))
    return header + struct.pack("<i", 16 + 4) + struct.pack("<i", len(comp)) + comp


@pytest.mark.parametrize("codec", [3, 1], ids=["zlib", "lz4"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_blosc_single_block_roundtrip(codec, shuffle):
    data = np.arange(512, dtype=np.float32)
    chunk = _make_blosc(data.tobytes(), 4, codec=codec, shuffle=shuffle)
    assert treader._blosc_decompress(chunk) == data.tobytes()
    assert treader._decode_chunk(chunk, {"id": "blosc"}) == data.tobytes()
    # one block of one stream: the JAX reader reads it right too
    assert jreader._decode_chunk(chunk, {"id": "blosc"}) == data.tobytes()


def test_blosc_memcpy():
    raw = b"0123456789abcdef"
    header = struct.pack("<BBBBIII", 2, 1, 0x2, 1, len(raw), len(raw), 16 + len(raw))
    assert treader._blosc_decompress(header + raw) == raw


def test_blosc_rejects_bitshuffle_and_unknown_codecs():
    raw = np.arange(16, dtype=np.float32).tobytes()
    with pytest.raises(ValueError, match="bit-shuffle"):
        treader._blosc_decompress(struct.pack("<BBBBIII", 2, 1, 0x4, 4, 64, 64, 80) + raw)
    chunk = bytearray(_make_blosc(raw, 4, codec=3, shuffle=False))
    chunk[2] = 2 << 5  # snappy
    with pytest.raises(ValueError, match="snappy"):
        treader._blosc_decompress(bytes(chunk))
    with pytest.raises(ValueError, match="Unsupported Zarr compressor"):
        treader._decode_chunk(raw, {"id": "lzma"})


def _blosc_two_block_shuffled(raw: bytes, typesize: int) -> bytes:
    """An independent c-blosc encoder for the frame c-blosc writes when a
    chunk spans two blocks: each block byte-shuffled ON ITS OWN, kept as
    one stream (flag 0x10, "not split"), zlib-compressed, behind the
    block-start table; from c-blosc's header spec (blosc.h)."""
    nbytes = len(raw)
    blocksize = nbytes // 2
    streams = []
    for b in range(2):
        block = np.frombuffer(raw[b * blocksize:(b + 1) * blocksize], np.uint8)
        streams.append(zlib.compress(block.reshape(-1, typesize).T.tobytes()))
    starts = [16 + 8, 16 + 8 + 4 + len(streams[0])]
    flags = 0x1 | 0x10 | (3 << 5)
    body = b"".join(struct.pack("<i", len(s)) + s for s in streams)
    header = struct.pack("<BBBBIII", 2, 1, flags, typesize, nbytes, blocksize,
                         16 + 8 + len(body))
    return header + struct.pack("<2i", *starts) + body


def test_two_block_shuffled_frame_is_misread_as_by_the_jax_reader():
    """R8 (ROADMAP Queue 3): c-blosc shuffles each block of a frame on its
    own, but the JAX reader unshuffles the whole chunk at once, so a frame
    of two shuffled blocks (every real ARCO-ERA5 chunk has many) decodes
    there to the right number of bytes in the wrong order.  The port
    unshuffles block by block and gets the data back."""
    data = np.arange(1024, dtype=np.float32) * 1.5 + 7.0
    frame = _blosc_two_block_shuffled(data.tobytes(), 4)
    misread = jreader._decode_chunk(frame, {"id": "blosc"})
    assert len(misread) == data.nbytes and misread != data.tobytes()
    assert treader._decode_chunk(frame, {"id": "blosc"}) == data.tobytes()


def test_split_stream_frame_is_read_short_as_by_the_jax_reader():
    """R8's second half: with flag 0x10 clear c-blosc splits a shuffled
    block into ``typesize`` streams, each behind its own size word (the
    LZ4 frames of ARCO-ERA5).  The JAX reader takes the first stream for
    the whole block, so the chunk decodes there to a quarter of its
    bytes; the port reads the four streams and interleaves them."""
    data = np.arange(256, dtype=np.float32) - 100.0
    planes = np.frombuffer(data.tobytes(), np.uint8).reshape(-1, 4).T
    streams = [zlib.compress(plane.tobytes()) for plane in planes]
    body = b"".join(struct.pack("<i", len(c)) + c for c in streams)
    header = struct.pack("<BBBBIII", 2, 1, 0x1 | (3 << 5), 4, data.nbytes, data.nbytes,
                         16 + 4 + len(body))
    frame = header + struct.pack("<i", 16 + 4) + body
    assert len(jreader._decode_chunk(frame, {"id": "blosc"})) == data.nbytes // 4
    assert treader._decode_chunk(frame, {"id": "blosc"}) == data.tobytes()


def _lz4_sequence(out: bytearray, literals: bytes, offset: int = 0, match: int = 0) -> None:
    """One LZ4 sequence: the literals, then (offset > 0) a match of
    ``match`` >= 4 bytes ``offset`` back."""
    extra = match - 4 if offset else 0
    out.append((min(len(literals), 15) << 4) | min(extra, 15))
    if len(literals) >= 15:
        out += _lz4_extension(len(literals) - 15)
    out += literals
    if offset:
        out += struct.pack("<H", offset)
        if extra >= 15:
            out += _lz4_extension(extra - 15)


def _lz4_greedy(raw: bytes) -> bytes:
    """A greedy LZ4 block encoder: at each position the last earlier one
    with the same four bytes, extended as far as the bytes agree.  On
    runs that match starts one byte back and runs on past its offset:
    the overlapping copy the decoder does byte by byte.  The format's end
    rules hold: no match starts within 12 bytes of the end, the last 5
    bytes are literals."""
    out, table, n = bytearray(), {}, len(raw)
    i = anchor = 0
    while i < n - 12:
        cand = table.get(raw[i : i + 4])
        table[raw[i : i + 4]] = i
        if cand is None or i - cand > 0xFFFF:
            i += 1
            continue
        length = 4
        while i + length < n - 5 and raw[cand + length] == raw[i + length]:
            length += 1
        _lz4_sequence(out, raw[anchor:i], i - cand, length)
        i = anchor = i + length
    _lz4_sequence(out, raw[anchor:])
    return bytes(out)


def test_greedy_lz4_encoder_emits_overlapping_matches():
    raw = bytes(100) + bytes(range(40)) * 3 + b"tail-bytes!"
    enc = _lz4_greedy(raw)
    assert len(enc) < len(raw) // 2
    assert treader._lz4_block_decompress(enc, len(raw)) == raw
    assert jreader._lz4_block_decompress(enc, len(raw)) == raw


_STREAM_CODECS = {"zlib": (3, lambda b: zlib.compress(b, 6)), "lz4": (1, _lz4_greedy)}


def _blosc_frame(raw: bytes, typesize: int, blocksize: int, codec: str, split: bool,
                 shuffle: bool = True) -> bytes:
    """A blosc1 frame as c-blosc 1.x's compressor lays it out, written
    from its description (blosc.h, blosc_c) rather than from the reader:
    the chunk cut into ``blocksize``-byte blocks, the last one ragged;
    each block byte-shuffled on its own; where ``split``, each whole
    block of typesize <= 16 and at least 128 elements cut into
    ``typesize`` equal streams (flag 0x10 clear), else one stream (flag
    0x10 set); each stream behind an int32 size word, stored raw where
    its code would not be shorter."""
    code, encode = _STREAM_CODECS[codec]
    nbytes = len(raw)
    n_blocks = -(-nbytes // blocksize)
    flags = (0x1 if shuffle else 0) | (0 if split else 0x10) | (code << 5)
    base = 16 + 4 * n_blocks
    starts, body = [], bytearray()
    for b in range(n_blocks):
        block = raw[b * blocksize : (b + 1) * blocksize]
        n = len(block) // typesize
        if shuffle:
            planes = np.frombuffer(block, np.uint8, count=n * typesize).reshape(n, typesize)
            block = planes.T.tobytes() + block[n * typesize :]
        whole = len(block) == blocksize
        nsplits = typesize if split and whole and typesize <= 16 and n >= 128 else 1
        size = len(block) // nsplits
        starts.append(base + len(body))
        for j in range(nsplits):
            stream = block[j * size : (j + 1) * size]
            comp = encode(stream)
            comp = comp if len(comp) < len(stream) else stream
            body += struct.pack("<i", len(comp)) + comp
    header = struct.pack("<BBBBIII", 2, 1, flags, typesize, nbytes, blocksize, base + len(body))
    return header + struct.pack(f"<{n_blocks}i", *starts) + bytes(body)


def _field_with_noise(rng, shape, dtype) -> np.ndarray:
    """A smooth field (compressible planes, runs in the high bytes) with
    one stretch of random bits (incompressible: raw streams)."""
    t = np.arange(int(np.prod(shape)), dtype=np.float64)
    out = (250.0 + 10.0 * np.sin(t / 50.0)).astype(dtype)
    bits = out.view(np.uint16 if out.itemsize == 2 else np.uint32)
    cut = bits.size // 3
    bits[cut : cut + 300] = rng.integers(0, 1 << (8 * out.itemsize - 2), 300)
    return out.reshape(shape)


def _jax_misreads(frame: bytes, chunk: bytes) -> bool:
    """Whether the JAX reader gets ``frame`` wrong: other bytes, or an
    error where it takes a split block's first stream for the block."""
    try:
        return jreader._decode_chunk(frame, {"id": "blosc"}) != chunk
    except (zlib.error, ValueError, IndexError):
        return True


@pytest.mark.parametrize("split", [True, False], ids=["split", "0x10"])
@pytest.mark.parametrize("typesize", [4, 2])
@pytest.mark.parametrize("codec", ["zlib", "lz4"])
def test_multi_block_frames_decode_through_the_store(tmp_path, codec, typesize, split):
    """R8's fix: frames of several blocks, the last ragged, shuffled block
    by block, with split streams (flag 0x10 clear) or not, compressed and
    raw streams, typesize 4 and 2, read through ``open_era5_zarr`` on a
    small store, decode to the array that built them.  The JAX reader
    misreads every such frame."""
    rng = np.random.default_rng(typesize + 2 * split)
    dtype = np.float32 if typesize == 4 else np.float16
    data = _field_with_noise(rng, (16, 1, 9, 10), dtype)
    root = tmp_path / "store"
    chunks = (8, 1, 9, 10)
    treader.write_zarr_array(root, "temperature", data, chunks=chunks,
                             dims=("time", "level", "latitude", "longitude"), compressor=None)
    meta_path = root / "temperature" / ".zarray"
    meta = json.loads(meta_path.read_text())
    meta["compressor"] = {"id": "blosc", "cname": codec, "clevel": 5, "shuffle": 1,
                          "blocksize": 0}
    meta_path.write_text(json.dumps(meta))
    blocksize = 256 * typesize  # 256 elements a block: three blocks a chunk
    for c in range(2):
        chunk = data[8 * c : 8 * (c + 1)].tobytes()
        assert len(chunk) % blocksize
        frame = _blosc_frame(chunk, typesize, blocksize, codec, split)
        (root / "temperature" / f"{c}.0.0.0").write_bytes(frame)
        assert _jax_misreads(frame, chunk)
    got = tzarr.open_era5_zarr(root)["temperature"][:]
    assert got.dtype == data.dtype
    np.testing.assert_array_equal(got, data)


def test_frames_built_by_c_blosc_decode(tmp_path):
    """Frames that c-blosc itself wrote (tensorstore's bundled c-blosc 1.x,
    where that package is installed): LZ4, zlib and zstd, shuffled or
    not, default and small blocks, an incompressible chunk (a memcpy frame
    whose shuffle flag stays set over raw bytes), decode to their arrays
    in the port."""
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(3)
    smooth = _field_with_noise(rng, (300_000,), np.float32)
    noise = rng.integers(0, 1 << 32, 300_000, dtype=np.uint32).view(np.float32)
    cases = [(smooth, cname, shuffle, bs) for cname in ("lz4", "zlib", "zstd")
             for shuffle in (0, 1) for bs in (0, 4096)] + [(noise, "lz4", 1, 0)]
    for i, (data, cname, shuffle, bs) in enumerate(cases):
        path = tmp_path / f"s{i}"
        spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": str(path)},
                "metadata": {"shape": [data.size], "chunks": [data.size], "dtype": "<f4",
                             "compressor": {"id": "blosc", "cname": cname, "clevel": 5,
                                            "shuffle": shuffle, "blocksize": bs}},
                "create": True}
        ts.open(spec).result().write(data).result()
        frame = (path / "0").read_bytes()
        assert treader._decode_chunk(frame, {"id": "blosc"}) == data.tobytes(), (cname, shuffle, bs)


# ------------------------------------------------------- ingest parity


def test_slice_pushdown_matches_fixture(era5_zarr):
    root, info = era5_zarr
    args = (root, ["temperature"], _when("2019-01-01T05"), _when("2019-01-01T20"), [1000])
    fs = tzarr.read_era5_zarr_slice(*args)
    fs_j = jzarr.read_era5_zarr_slice(*args)
    ref = info["data"]["temperature"][5:21, [1]]
    assert fs["temperature"].data.tobytes() == ref.tobytes() == fs_j["temperature"].data.tobytes()
    np.testing.assert_array_equal(fs.coord("level").values, np.asarray([1000]))
    assert fs.coord("time").values[0] == np.datetime64("2019-01-01T05", "ns")
    for name in ("time", "level", "latitude", "longitude"):
        np.testing.assert_array_equal(fs.coord(name).values, fs_j.coord(name).values)
    assert fs["temperature"].dims == fs_j["temperature"].dims
    assert fs.attrs == fs_j.attrs and fs["temperature"].attrs == fs_j["temperature"].attrs


def test_slice_of_a_store_in_another_dim_order(tmp_path):
    """A variable stored (level, time, latitude, longitude) is read back
    in canonical order, as by the JAX reader."""
    root = tmp_path / "z"
    make_era5_zarr_fixture(root, variables=())  # the coordinates alone
    data = np.random.default_rng(2).standard_normal((2, 30, 9, 10)).astype(np.float32)
    treader.write_zarr_array(root, "temperature", data, chunks=(1, 8, 9, 10),
                             dims=("level", "time", "latitude", "longitude"))
    args = (root, ["temperature"], _when("2019-01-01T03"), _when("2019-01-01T11"), [850])
    fs = tzarr.read_era5_zarr_slice(*args)
    want = np.transpose(data, (1, 0, 2, 3))[3:12, :1]
    assert fs["temperature"].data.tobytes() == want.tobytes()
    assert fs["temperature"].data.tobytes() == jzarr.read_era5_zarr_slice(*args)[
        "temperature"].data.tobytes()


def test_out_of_bounds_raises(era5_zarr):
    root, _ = era5_zarr
    for module in (tzarr, jzarr):
        with pytest.raises(ValueError, match="outside dataset bounds"):
            module.read_era5_zarr_slice(root, ["temperature"], _when("2018-12-31T00"),
                                        _when("2019-01-01T10"))


def test_missing_variable_and_level_raise(era5_zarr):
    root, _ = era5_zarr
    with pytest.raises(ValueError, match="not present"):
        tzarr.read_era5_zarr_slice(root, ["v_component_of_wind"], _when("2019-01-01T00"),
                                   _when("2019-01-01T10"))
    with pytest.raises(ValueError, match="Requested level is not available"):
        tzarr.read_era5_zarr_slice(root, ["temperature"], _when("2019-01-01T00"),
                                   _when("2019-01-01T10"), levels=[500])


@pytest.fixture()
def roots(tmp_path, monkeypatch):
    """use(name) points both packages' DMD_ERA5_TPU_ROOT at tmp_path/name."""
    monkeypatch.delenv("DMD_ERA5_TPU_REMOTE", raising=False)

    def use(name: str) -> Path:
        monkeypatch.setenv("DMD_ERA5_TPU_ROOT", str(tmp_path / name))
        return tmp_path / name

    return use


def test_download_stage_end_to_end(era5_zarr, roots):
    """download_era5_data from a local store, against the JAX stage on
    the same config: the same slice, resampled, stamped and saved."""
    from dmd_era5_tpu.pipeline import era5_download as dl_jax
    from dmd_era5_tpu_torch.pipeline import era5_download
    from dmd_era5_tpu_torch.utils.io_h5 import load_fieldset

    root, info = era5_zarr
    config = {"source_path": str(root), "start_datetime": "2019-01-01T02",
              "end_datetime": "2019-01-02T02", "delta_time": "2h",
              "variables": "temperature,u_component_of_wind", "levels": "850,1000"}
    roots("port")
    parsed = config_parser(dict(config), "era5-download")
    fs = era5_download.download_era5_data(parsed, use_mock_data=False)
    roots("jax")
    fs_j = dl_jax.download_era5_data(dl_jax.config_parser(dict(config), "era5-download"),
                                     use_mock_data=False)
    assert Path(parsed["save_path"]).exists()
    assert fs.sizes["time"] == 13  # 2h resampling of hours [2, 26]
    for var in ("temperature", "u_component_of_wind"):
        ref = info["data"][var][2:27:2]
        assert fs[var].data.tobytes() == ref.tobytes() == fs_j[var].data.tobytes()
    saved = load_fieldset(parsed["save_path"])
    assert saved.attrs["source_path"] == str(root)
    np.testing.assert_array_equal(saved["temperature"].values,
                                  info["data"]["temperature"][2:27:2])
    volatile = {"date_downloaded", "download_seconds", "download_melem_per_s"}
    assert {k: v for k, v in fs.attrs.items() if k not in volatile} == {
        k: v for k, v in fs_j.attrs.items() if k not in volatile}


def test_download_main_from_a_store_with_the_store_of_artifacts(era5_zarr, roots):
    from dmd_era5_tpu_torch.pipeline import era5_download

    root, _ = era5_zarr
    roots("port")
    config = {"source_path": str(root), "start_datetime": "2019-01-01T00",
              "end_datetime": "2019-01-01T12", "delta_time": "1h",
              "variables": "temperature", "levels": "1000"}
    assert era5_download.main(dict(config), use_store=True) == (True, False)
    assert era5_download.main(dict(config), use_store=True) == (False, True)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("time_chunk", [8, 1])
def test_zarr_to_packed_matches_inmem_pack(tmp_path, bf16, time_chunk, monkeypatch):
    """Chunk-streamed packing == materialize-then-pack, to HDF5 (read by
    either package, bit for bit with the JAX package's own file) and to
    .npy.  Hourly chunks and a buffer of 3 hours make the port gather
    and flush several times."""
    root = tmp_path / "era5.zarr"
    make_era5_zarr_fixture(root, "jax", time_chunk=time_chunk)
    monkeypatch.setattr(tzarr, "PACK_BUFFER_BYTES", 3 * 4 * 2 * 9 * 10)
    start, end = _when("2019-01-01T00"), _when("2019-01-02T05")
    variables, levels = ["temperature", "u_component_of_wind"], [850, 1000]
    fs = tzarr.read_era5_zarr_slice(root, variables, start, end, levels)
    x_ref, meta = tloader.build_snapshot_matrix(fs, variables, bf16=bf16)
    x_jax, _ = jloader.build_snapshot_matrix(
        jzarr.read_era5_zarr_slice(root, variables, start, end, levels), variables, bf16=bf16)
    assert x_ref.tobytes() == x_jax.tobytes()

    port_h5, jax_h5, port_npy = tmp_path / "p.h5", tmp_path / "j.h5", tmp_path / "p.npy"
    for path in (port_h5, port_npy):
        assert tzarr.zarr_to_packed(root, path, variables, start, end, levels,
                                    bf16=bf16) == x_ref.shape
    jzarr.zarr_to_packed(root, jax_h5, variables, start, end, levels, bf16=bf16)
    for path in (port_h5, jax_h5, port_npy):
        for loader in (tloader, jloader) if path.suffix == ".h5" else (tloader,):
            shape, meta2, flag = loader.packed_info(path)
            assert shape == x_ref.shape and flag == bf16
            assert loader.read_packed_rows(path, 0, shape[0]).tobytes() == x_ref.tobytes()
            if path.suffix == ".h5":
                assert meta2.variables == variables
                for name in ("levels", "latitudes", "longitudes", "times"):
                    np.testing.assert_array_equal(getattr(meta2, name), getattr(meta, name))
    import h5py

    with h5py.File(port_h5, "r") as fp, h5py.File(jax_h5, "r") as fj:
        assert sorted(fp) == sorted(fj) and dict(fp.attrs) == dict(fj.attrs)
        assert fp["X"].chunks == fj["X"].chunks and fp["X"].dtype == fj["X"].dtype
        for name in fj:
            a, b = fp[name][()], fj[name][()]
            assert a.dtype == b.dtype, name
            assert a.tolist() == b.tolist() if a.dtype == object else a.tobytes() == b.tobytes()


# ------------------------------------------ the committed ARCO fixtures


@pytest.fixture()
def arco_mini(tmp_path) -> Path:
    """The committed mini store with flag 0x10 set on every blosc chunk.
    Its encoder (``fixtures/make_arco_fixture.py``) writes each chunk as
    one block of ONE stream but leaves 0x10 ("not split") clear, so
    c-blosc, and the port, expect four streams there and refuse the
    frame; with the flag the frame says what it holds, and the JAX
    reader, which ignores the flag, reads the same bytes as before."""
    import shutil

    root = tmp_path / "arco_era5_mini"
    shutil.copytree(FIXTURES / "arco_era5_mini", root)
    meta = json.loads((root / ".zmetadata").read_text())["metadata"]
    blosc = [key.split("/")[0] for key, node in meta.items()
             if key.endswith(".zarray") and (node["compressor"] or {}).get("id") == "blosc"]
    assert blosc
    for chunk in (c for name in blosc for c in (root / name).glob("[0-9]*")):
        frame = bytearray(chunk.read_bytes())
        frame[2] |= 0x10
        chunk.write_bytes(bytes(frame))
    return root


def test_committed_mini_frames_are_refused_as_c_blosc_refuses_them():
    """The committed mini store's frames (one stream, 0x10 clear): the JAX
    reader reads them; the port, like c-blosc, expects a split block and
    refuses them."""
    frame = (FIXTURES / "arco_era5_mini" / "temperature" / "0.0.0.0").read_bytes()
    assert frame[2] & 0x10 == 0
    assert len(jreader._decode_chunk(frame, {"id": "blosc"})) == 5 * 7 * 12 * 4
    with pytest.raises(ValueError, match="expected 420"):
        treader._decode_chunk(frame, {"id": "blosc"})


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_arco_mini_store_slice_values(reader, arco_mini):
    module = {"jax": jzarr, "port": tzarr}[reader]
    fs = module.read_era5_zarr_slice(FIXTURES / "arco_era5_mini" if reader == "jax" else arco_mini,
                                     ["temperature", "v_component_of_wind"],
                                     datetime(1959, 1, 1, 1), datetime(1959, 1, 1, 3),
                                     levels=[200, 1000])
    temp = fs["temperature"]
    assert temp.data.shape == (3, 2, 7, 12)
    np.testing.assert_array_equal(
        temp.coords["time"].values,
        np.arange("1959-01-01T01", "1959-01-01T04", dtype="datetime64[h]").astype("datetime64[ns]"),
    )
    np.testing.assert_array_equal(temp.coords["level"].values, [200, 1000])
    # latitude comes through DESCENDING, exactly as stored
    np.testing.assert_array_equal(temp.coords["latitude"].values,
                                  np.arange(90.0, -90.1, -30.0, dtype=np.float32))
    # value = var*100000 + t*10000 + lev*1000 + lat*100 + lon
    assert temp.data[0, 0, 0, 0] == 1 * 10000 + 1 * 1000  # t=1, lev_idx=1
    assert temp.data[2, 1, 3, 5] == 3 * 10000 + 4 * 1000 + 3 * 100 + 5
    assert fs["v_component_of_wind"].data[0, 0, 0, 0] == 2 * 100000 + 1 * 10000 + 1 * 1000


def test_arco_mini_missing_chunk_is_nan_fill_in_both_and_in_the_packed_bf16(arco_mini):
    """A missing chunk reads as the NaN fill (times t=3,4,5; chunk t=4 is
    absent), the canonical quiet NaN bit for bit in both readers, and
    packs to the same bf16 word 0x7FC0 as the JAX package's packer."""
    args = (arco_mini, ["temperature"], datetime(1959, 1, 1, 3),
            datetime(1959, 1, 1, 5), [50])
    fs, fs_j = tzarr.read_era5_zarr_slice(*args), jzarr.read_era5_zarr_slice(*args)
    data = fs["temperature"].data
    assert np.isfinite(data[0]).all() and np.isfinite(data[2]).all()
    assert np.isnan(data[1]).all()
    assert data.tobytes() == fs_j["temperature"].data.tobytes()
    assert set(data[1].view(np.uint32).ravel().tolist()) == {0x7FC00000}
    words, _ = tloader.build_snapshot_matrix(fs, bf16=True)
    words_j, _ = jloader.build_snapshot_matrix(fs_j, bf16=True)
    assert words.tobytes() == words_j.tobytes()
    assert set(words[:, 1].tolist()) == {0x7FC0}


def test_arco_mini_packed_to_npy_equals_the_jax_packed_h5(tmp_path, arco_mini):
    args = (arco_mini, ["u_component_of_wind", "temperature"],
            datetime(1959, 1, 1, 0), datetime(1959, 1, 1, 5))
    tzarr.zarr_to_packed(args[0], tmp_path / "p.npy", *args[1:])
    jzarr.zarr_to_packed(args[0], tmp_path / "j.h5", *args[1:])
    want = jloader.read_packed_rows(tmp_path / "j.h5", 0, 2 * 5 * 7 * 12)
    assert np.load(tmp_path / "p.npy").tobytes() == want.tobytes()


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_arco_fullscale_metadata_and_chunk_pushdown(reader):
    """The full-scale consolidated metadata (37 levels, 721 x 1440, hourly
    1959-2022, chunks [1, 37, 721, 1440]): slice pushdown fetches exactly
    the covering chunk keys, one store key per requested hour."""
    consolidated = json.loads(
        (FIXTURES / "arco_era5_fullscale.zmetadata.json").read_text())["metadata"]
    requested: list[str] = []

    class RecordingStore:
        def get(self, key):
            requested.append(key)
            return None  # no chunk bytes: reads resolve to fill values

        def list_prefix(self, prefix=""):
            return []

    group = READERS[reader].ZarrGroup(RecordingStore(), consolidated=consolidated)
    assert set(group.array_keys()) >= {"temperature", "u_component_of_wind",
                                       "v_component_of_wind"}
    temp = group["temperature"]
    assert temp.shape == (23376 * 24, 37, 721, 1440)
    assert temp.chunks == (1, 37, 721, 1440)
    assert temp.dims == ("time", "level", "latitude", "longitude")
    assert temp.compressor["id"] == "blosc"
    t0 = 100_000
    block = temp[t0 : t0 + 24, :, :2, :2]
    assert block.shape == (24, 37, 2, 2)
    assert np.isnan(block).all()
    keys = [k for k in requested if k.startswith("temperature/")]
    assert keys == [f"temperature/{t}.0.0.0" for t in range(t0, t0 + 24)]


# --------------------------------------- config.ini on a local Zarr store

PAIRS = ((-0.002, 24.0, 3.0), (-0.004, 12.0, 2.0), (-0.001, 84.0, 1.5))


def _planted_store(root: Path) -> np.ndarray:
    """An hourly store around config.ini's window (2018-12-31T22 to
    2019-01-05T02, temperature at 850 and 1000 hPa, a 9 x 12 grid): per
    grid row a mean, three planted damped pairs and 1% noise.  Returns
    the six planted eigenvalues (per hour)."""
    rng = np.random.default_rng(11)
    n_time, n_lat, n_lon = 101, 9, 12
    hours = np.arange(n_time, dtype=np.float64)
    alpha = np.array([complex(d, 2 * math.pi / p) for d, p, _ in PAIRS])
    amps = np.array([a for *_, a in PAIRS])
    dyn = amps[:, None] * np.exp(alpha[:, None] * hours[None, :])
    rows = 2 * n_lat * n_lon
    c = rng.standard_normal((rows, 3)) + 1j * rng.standard_normal((rows, 3))
    x = 250.0 + rng.standard_normal((rows, 1)) + np.real(c @ dyn)
    x += 0.01 * np.sqrt((np.abs(dyn) ** 2).sum(0).mean()) * rng.standard_normal(x.shape)
    field = x.T.reshape(n_time, 2, n_lat, n_lon).astype(np.float32)
    make_era5_zarr_fixture(root, "port", n_time=n_time, levels=(850, 1000), n_lat=n_lat,
                           n_lon=n_lon, variables=("temperature",), time_chunk=1,
                           start="2018-12-31T22", data={"temperature": field})
    return np.concatenate([alpha, alpha.conj()])


def _matched_error(found, true) -> float:
    left, err = list(found), 0.0
    for tv in true:
        i = int(np.argmin([abs(f - tv) for f in left]))
        err = max(err, abs(left.pop(i) - tv))
    return err


def test_config_ini_runs_from_a_local_zarr_store(roots, tmp_path):
    """config.ini's [era5-download], [era5-svd] and [era5-dmd] as they are
    but for source_path, a local store of hourly chunks: the three stage
    mains of the port on the CPU (era5_download.main with the store, then
    era5_svd.main and era5_dmd.main, which take the slice from the
    workdir): the JAX download stage saves the same slice, the DMD stage
    recovers the planted eigenvalues."""
    from dmd_era5_tpu.pipeline import era5_download as dl_jax
    from dmd_era5_tpu_torch.pipeline import era5_dmd, era5_download, era5_svd
    from dmd_era5_tpu_torch.utils.io_h5 import load_fieldset

    store = tmp_path / "arco.zarr"
    planted = _planted_store(store)
    sections = {name: {**config_reader(name, CONFIG), "source_path": str(store)}
                for name in ("era5-download", "era5-svd", "era5-dmd")}
    roots("jax")
    dl_jax.download_era5_data(dl_jax.config_parser(dict(sections["era5-download"]),
                                                   "era5-download"))
    want = load_fieldset(dl_jax.config_parser(dict(sections["era5-download"]),
                                              "era5-download")["save_path"])
    roots("port")
    assert era5_download.main(dict(sections["era5-download"]), use_store=True) == (True, False)
    parsed = config_parser(dict(sections["era5-download"]), "era5-download")
    got = load_fieldset(parsed["save_path"])
    assert got.sizes == {"time": 97, "level": 1, "latitude": 9, "longitude": 12}
    assert got["temperature"].values.tobytes() == want["temperature"].values.tobytes()
    svd, _, _ = era5_svd.main(dict(sections["era5-svd"]), write_artifact=True, device="cpu")
    assert svd["U"].shape == (2 * 9 * 12, 10) and svd.attrs["svd_backend"] == "hankel"
    dmd, added, retrieved = era5_dmd.main(dict(sections["era5-dmd"]), device="cpu")
    assert not added and not retrieved
    assert dmd["modes"].shape == (2 * 9 * 12, 6) and dmd["forecast"].shape == (108, 96 + 24)
    assert _matched_error(dmd["eigenvalues"].values, planted) < 1e-2
