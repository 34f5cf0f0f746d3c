"""The packed snapshot-matrix artifact: build it, write it, size it, read row blocks.

PyTorch-side counterpart of ``dmd_era5_tpu/snapmat/loader.py`` on one
device: :class:`SnapshotMeta` (:42), :func:`build_snapshot_matrix` (:60),
:func:`save_packed_snapshot` (:90), :func:`save_packed_matrix` (:115),
:func:`packed_info` (:159), :func:`read_packed_rows` (:181) and
:func:`host_row_stats` (:255).  The out-of-core SVD backends
(``pipeline/streamed_fit.py``) stream what these write, and
:func:`load_row_sharded` (:187) reads a rank's row block of it onto the
mesh.

A source is one of

- an HDF5 file (any path not ending in ``.npy``): dataset ``X``, the
  attribute ``bf16`` and, when written from a FieldSet, the datasets
  ``variables``, ``levels``, ``latitudes``, ``longitudes`` and ``times``:
  the JAX package's format, dataset for dataset, so either package reads
  what the other writes.  ``h5py`` is imported by the functions that
  touch such a file, never with this module;
- a ``.npy`` file, opened with ``np.load(..., mmap_mode="r")``; it holds
  X alone, so its meta is the empty :class:`SnapshotMeta`, as for a
  coordinate-free HDF5 file;
- an in-memory ``np.ndarray`` (meta empty as well).

uint16 storage means bf16 bit patterns (the loader contract of the JAX
package, ``dmd_era5_tpu/pipeline/streamed_fit.py:157-158``); an HDF5
file says so in its ``bf16`` attribute as well.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from dmd_era5_tpu_torch.native import bf16_words_of, pack_space_time, row_stats
from dmd_era5_tpu_torch.parallel.sharding import row_block
from dmd_era5_tpu_torch.utils.labels import FieldSet

__all__ = [
    "SnapshotMeta",
    "build_snapshot_matrix",
    "save_packed_snapshot",
    "save_packed_matrix",
    "packed_info",
    "read_packed_rows",
    "load_row_sharded",
    "host_row_stats",
]

_WRITE_ROWS = 1 << 18  # rows converted and written at a time


def _is_npy(path) -> bool:
    return str(path).endswith(".npy")


def _bf16_bits(block: torch.Tensor) -> np.ndarray:
    """f32 values (on any device) -> their bf16 bit patterns (uint16) on
    the host, rounded as ``native.pack_space_time`` rounds them."""
    return bf16_words_of(block).cpu().numpy().view(np.uint16)


class SnapshotMeta(NamedTuple):
    """Row/column bookkeeping of a packed snapshot matrix."""

    variables: list[str]
    levels: np.ndarray
    latitudes: np.ndarray
    longitudes: np.ndarray
    times: np.ndarray  # datetime64

    @property
    def n_space_per_var(self) -> int:
        return len(self.levels) * len(self.latitudes) * len(self.longitudes)

    @property
    def n_rows(self) -> int:
        return self.n_space_per_var * len(self.variables)


def _empty_meta() -> SnapshotMeta:
    empty = np.empty(0)
    return SnapshotMeta([], empty, empty, empty, np.empty(0, "datetime64[ns]"))


def build_snapshot_matrix(
    fs: FieldSet,
    variables: list[str] | None = None,
    bf16: bool = False,
) -> tuple[np.ndarray, SnapshotMeta]:
    """FieldSet (host numpy fields) -> (space, time) matrix on the host,
    through ``native.pack_space_time``.

    The row layout is ``flatten_era5_variables``': per variable a
    row-major (level, latitude, longitude) block, variables concatenated
    in order.  With ``bf16=True`` the matrix holds bf16 words (uint16).
    """
    variables = variables or fs.variables
    meta = SnapshotMeta(
        variables=list(variables),
        levels=np.asarray(fs.coord("level").values),
        latitudes=np.asarray(fs.coord("latitude").values),
        longitudes=np.asarray(fs.coord("longitude").values),
        times=np.asarray(fs.coord("time").values),
    )
    blocks = []
    for var in variables:
        field = fs[var].transpose("time", "level", "latitude", "longitude")
        arr = np.asarray(field.data, dtype=np.float32)
        # (T, L, A, O) row-major is (T, n_space) in the (level, lat, lon) stack order
        blocks.append(pack_space_time(arr.reshape(arr.shape[0], -1), bf16=bf16))
    return np.concatenate(blocks, axis=0), meta


def write_meta(f, meta: SnapshotMeta) -> None:
    """Write meta as the JAX package's coordinate datasets into an open
    packed HDF5 file ``f``."""
    import h5py

    f.create_dataset("variables", data=np.asarray(meta.variables, dtype=h5py.string_dtype()))
    f.create_dataset("levels", data=meta.levels)
    f.create_dataset("latitudes", data=meta.latitudes)
    f.create_dataset("longitudes", data=meta.longitudes)
    f.create_dataset("times", data=meta.times.astype("datetime64[ns]").astype(np.int64))


def save_packed_snapshot(
    path: str | Path,
    x: np.ndarray,
    meta: SnapshotMeta,
    row_chunk: int = 4096,
) -> None:
    """Persist a packed matrix from :func:`build_snapshot_matrix`.

    HDF5 as the JAX package writes it: X in ``row_chunk``-row chunks of
    whole rows, ``bf16`` set for uint16 words, and the coordinates of
    ``meta``.  A ``.npy`` path holds X alone (its meta reads back empty).
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if _is_npy(path):
        np.save(path, x)
        return
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=x, chunks=(min(row_chunk, x.shape[0]), x.shape[1]))
        f.attrs["bf16"] = int(x.dtype == np.uint16)
        write_meta(f, meta)


def save_packed_matrix(
    path: str | Path,
    x: np.ndarray | torch.Tensor,
    d: int = 1,
    row_chunk: int = 4096,
    bf16: bool = False,
) -> tuple[int, int]:
    """Persist a (coordinate-free) snapshot matrix, optionally delay-embedded.

    With ``d > 1`` the file holds H_d(X): rows S*d, block j =
    ``x[:, j : j+T-d+1]`` (the ``snapmat/transform.py`` layout), written
    slab by slab and row chunk by row chunk, so neither the d-fold Hankel
    matrix nor a host copy of x exists at once.  ``x`` may be a numpy
    array or a tensor on any device; each chunk is converted (to bf16
    bit patterns with ``bf16=True``) on x's device and copied to the
    host.  A ``.npy`` path is written through ``np.lib.format.
    open_memmap``; any other path as HDF5 (dataset ``X`` in
    ``row_chunk``-row chunks, attributes ``bf16`` and
    ``delay_embedding``).

    Returns the packed (rows, cols).
    """
    if x.ndim != 2:
        raise ValueError("save_packed_matrix expects a 2-D (space, time) array")
    s_rows, t_cols = x.shape
    t_out = t_cols - d + 1
    if t_out < 1:
        raise ValueError("Delay embedding longer than the time series.")
    n_rows = s_rows * d
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    dtype = np.uint16 if bf16 else np.float32
    xt = torch.from_numpy(x) if isinstance(x, np.ndarray) else x

    def write_all(dest) -> None:
        for j in range(d):
            for r0 in range(0, s_rows, _WRITE_ROWS):
                r1 = min(r0 + _WRITE_ROWS, s_rows)
                chunk = xt[r0:r1, j : j + t_out].float()
                host = _bf16_bits(chunk) if bf16 else chunk.cpu().numpy()
                dest[j * s_rows + r0 : j * s_rows + r1] = host

    if _is_npy(path):
        dest = np.lib.format.open_memmap(path, mode="w+", dtype=dtype, shape=(n_rows, t_out))
        try:
            write_all(dest)
            dest.flush()
        finally:
            del dest
    else:
        import h5py

        with h5py.File(path, "w") as f:
            dset = f.create_dataset(
                "X", shape=(n_rows, t_out), dtype=dtype,
                chunks=(min(row_chunk, n_rows), t_out),
            )
            f.attrs["bf16"] = int(bf16)
            f.attrs["delay_embedding"] = d
            write_all(dset)
    return n_rows, t_out


def packed_info(
    source: str | Path | np.ndarray,
) -> tuple[tuple[int, int], SnapshotMeta, bool]:
    """((rows, cols), meta, bf16) of a packed source.  The meta is empty
    for an array, a ``.npy`` file or a coordinate-free HDF5 file
    (:func:`save_packed_matrix`'s): the streamed readers need the shape
    alone."""
    if isinstance(source, np.ndarray):
        return tuple(source.shape), _empty_meta(), source.dtype == np.uint16
    if _is_npy(source):
        arr = np.load(source, mmap_mode="r")
        return tuple(arr.shape), _empty_meta(), arr.dtype == np.uint16
    import h5py

    with h5py.File(source, "r") as f:
        shape, bf16 = tuple(f["X"].shape), bool(f.attrs.get("bf16", 0))
        if "variables" not in f:
            return shape, _empty_meta(), bf16
        meta = SnapshotMeta(
            variables=[v.decode() for v in f["variables"][()]],
            levels=f["levels"][()],
            latitudes=f["latitudes"][()],
            longitudes=f["longitudes"][()],
            times=f["times"][()].astype("datetime64[ns]"),
        )
    return shape, meta, bf16


def read_packed_rows(source: str | Path | np.ndarray, r0: int, r1: int,
                     into=None) -> np.ndarray:
    """Rows [r0, r1) of a packed source, read into host memory (a view of
    a writable in-memory array; a copy of a read-only one, such as an
    ``np.load(..., mmap_mode="r")`` memmap).  ``into``: a callable
    (shape, dtype) -> array, such as a pinned staging buffer, that the
    rows are read into and which is returned."""
    if isinstance(source, np.ndarray) or _is_npy(source):
        arr = source if isinstance(source, np.ndarray) else np.load(source, mmap_mode="r")
        rows = arr[r0:r1]
        if into is not None:
            dest = into(rows.shape, rows.dtype)
            np.copyto(dest, rows)
            return dest
        return rows if rows.flags.writeable else np.array(rows)
    import h5py

    with h5py.File(source, "r") as f:
        dset = f["X"]
        if into is None:
            return dset[r0:r1, :]
        dest = into((r1 - r0, dset.shape[1]), dset.dtype)
        dset.read_direct(dest, np.s_[r0:r1, :])
        return dest


def load_row_sharded(
    source: str | Path | np.ndarray,
    mesh,
    axis: str = "space",
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, int]:
    """This rank's row block of a packed snapshot matrix on the mesh's
    device (``dmd_era5_tpu/snapmat/loader.py:187``).

    The rows are zero-padded up to a multiple of the ``axis`` size and cut
    into equal blocks (``parallel.sharding.row_block``), block i on the
    ranks at index i of the axis; each
    rank reads only its own rows (an HDF5 hyperslab, a ``.npy`` memmap
    slice) straight into a host buffer that holds the padding too (pinned
    when the device is a card).  A bf16 source (uint16 words) stays bf16,
    any other is cast to ``dtype``.  Returns (local block, original rows).
    """
    (n_rows, n_cols), _, bf16 = packed_info(source)
    r0, r1, per = row_block(n_rows, mesh.shape[axis], mesh.coords[axis])
    host = []

    def into(shape, stored):  # the buffer in the source's own element type
        host.append(torch.zeros((per, n_cols), dtype=torch.from_numpy(np.empty(0, stored)).dtype,
                                pin_memory=mesh.device.type == "cuda"))
        return host[0].numpy()[: shape[0]]

    if r1 > r0:
        read_packed_rows(source, r0, r1, into=into)
    else:  # a block wholly of padding
        host.append(torch.zeros((per, n_cols), dtype=torch.int16 if bf16 else torch.float32))
    block = host[0].view(torch.bfloat16) if bf16 else host[0]
    return block.to(mesh.device, dtype=torch.bfloat16 if bf16 else dtype), n_rows


def host_row_stats(x: np.ndarray, ddof: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """One-pass per-row (mean, std) on the host: ingest-side statistics."""
    return row_stats(x, ddof=ddof)
