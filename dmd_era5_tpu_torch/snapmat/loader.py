"""The packed snapshot-matrix artifact: write it, size it, read row blocks.

PyTorch-side counterpart of the coordinate-free part of
``dmd_era5_tpu/snapmat/loader.py``: :func:`save_packed_matrix` (:115),
:func:`packed_info` (:159) and :func:`read_packed_rows` (:181), which
the out-of-core SVD backends (``pipeline/streamed_fit.py``) stream.

A source is one of

- an HDF5 file (any path not ending in ``.npy``): dataset ``X`` and the
  attribute ``bf16``, the JAX package's format.  ``h5py`` is imported
  by the functions that touch such a file, never with this module;
- a ``.npy`` file, opened with ``np.load(..., mmap_mode="r")``;
- an in-memory ``np.ndarray``.

uint16 storage means bf16 bit patterns (the loader contract of the JAX
package, ``dmd_era5_tpu/pipeline/streamed_fit.py:157-158``); an HDF5
file says so in its ``bf16`` attribute as well.  ``SnapshotMeta`` and the
FieldSet-based writers come with the ported FieldSet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["save_packed_matrix", "packed_info", "read_packed_rows"]

_WRITE_ROWS = 1 << 18  # rows converted and written at a time


def _is_npy(path) -> bool:
    return str(path).endswith(".npy")


def _bf16_bits(block: torch.Tensor) -> np.ndarray:
    """f32 values -> their bf16 bit patterns (uint16), rounded to nearest
    even as the JAX package's native packer rounds finite values
    (``dmd_era5_tpu/native/packer.cpp:26-31``)."""
    bits = block.to(torch.bfloat16).view(torch.int16).cpu().numpy()
    return bits.view(np.uint16)


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


def packed_info(source: str | Path | np.ndarray) -> tuple[tuple[int, int], bool]:
    """((rows, cols), bf16) of a packed source."""
    if isinstance(source, np.ndarray):
        return tuple(source.shape), source.dtype == np.uint16
    if _is_npy(source):
        arr = np.load(source, mmap_mode="r")
        return tuple(arr.shape), arr.dtype == np.uint16
    import h5py

    with h5py.File(source, "r") as f:
        return tuple(f["X"].shape), bool(f.attrs.get("bf16", 0))


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
