"""Layouts of a global array over the mesh, padding, cutting and moving blocks.

PyTorch counterpart of ``dmd_era5_tpu/parallel/sharding.py``.  Where the
JAX package names a ``NamedSharding`` and lets XLA place the blocks, the
port's SPMD code holds this rank's local block and a :class:`Layout`
that says which mesh axis splits which dimension: :func:`shard_rows`
and :meth:`Layout.local_block` cut a rank's block out of a global array,
and :func:`reshard` moves blocks between two layouts with the axis
collectives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dmd_era5_tpu_torch.parallel.collectives import all_gather, all_to_all
from dmd_era5_tpu_torch.parallel.mesh import AXIS_SPACE, AXIS_TIME, MESH_AXES, Mesh

__all__ = [
    "Layout",
    "replicated",
    "row_sharded",
    "col_sharded",
    "grid_sharded",
    "pad_rows_to_multiple",
    "row_block",
    "shard_rows",
    "reshard",
    "assemble_rows",
]


@dataclass(frozen=True)
class Layout:
    """``spec[d]``: the mesh axis that splits dimension d, or None (the
    dimension whole on every rank); dimensions past the spec are whole,
    like a ``PartitionSpec``."""

    mesh: Mesh
    spec: tuple[str | None, ...]

    def dim_of(self, axis: str) -> int | None:
        return self.spec.index(axis) if axis in self.spec else None

    def local_block(self, x):
        """This rank's block of the global array x (a view where x allows);
        each split dimension must divide by its axis's size."""
        index = []
        for d, axis in enumerate(self.spec):
            if axis is None:
                index.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide over "
                                 f"{n} ranks of {axis!r}")
            step = x.shape[d] // n
            index.append(slice(self.mesh.coords[axis] * step,
                               (self.mesh.coords[axis] + 1) * step))
        return x[tuple(index)]


def replicated(mesh: Mesh) -> Layout:
    return Layout(mesh, ())


def row_sharded(mesh: Mesh, axis: str = AXIS_SPACE) -> Layout:
    """(S, T) snapshot matrix with rows split over a mesh axis."""
    return Layout(mesh, (axis, None))


def col_sharded(mesh: Mesh, axis: str = AXIS_TIME) -> Layout:
    """(S, T) snapshot matrix with columns split over a mesh axis."""
    return Layout(mesh, (None, axis))


def grid_sharded(mesh: Mesh) -> Layout:
    """(S, T) split over both space and time axes."""
    return Layout(mesh, (AXIS_SPACE, AXIS_TIME))


def pad_rows_to_multiple(x, multiple: int):
    """Zero-pad axis 0 to a multiple; returns (padded, original_rows).

    Zero rows are exact no-ops for QR/GEMM-based factorizations, so
    padding is the cheap way to make row counts divide the mesh.
    """
    rows = x.shape[0]
    target = -(-rows // multiple) * multiple
    if target == rows:
        return x, rows
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((target - rows, *x.shape[1:]))]), rows
    return np.pad(x, [(0, target - rows)] + [(0, 0)] * (x.ndim - 1)), rows


def row_block(rows: int, n_shards: int, index: int) -> tuple[int, int, int]:
    """Block ``index`` of ``rows`` rows zero-padded to a multiple of
    ``n_shards`` and cut into equal blocks: (r0, r1, per), its rows
    [r0, r1) of the original and the padded block's length ``per``."""
    per = -(-rows // n_shards)
    r0 = min(index * per, rows)
    return r0, min(r0 + per, rows), per


def shard_rows(x, mesh: Mesh, axis: str = AXIS_SPACE) -> tuple[torch.Tensor, int]:
    """This rank's row block of the global (S, ...) array x on the mesh's
    device, the rows zero-padded to a multiple of the axis's size
    (:func:`row_block`); returns (local block, original rows)."""
    rows = x.shape[0]
    r0, r1, per = row_block(rows, mesh.shape[axis], mesh.coords[axis])
    block = x[r0:r1]
    block = torch.as_tensor(block).to(mesh.device)
    if block.shape[0] < per:
        block = torch.cat([block, block.new_zeros((per - block.shape[0], *block.shape[1:]))])
    return block, rows


def reshard(x: torch.Tensor, src: Layout, dst: Layout) -> torch.Tensor:
    """Move this rank's block of ``src`` to its block of ``dst``, one mesh
    axis at a time: a dimension that changes axis goes by one
    ``all_to_all`` (the Ulysses swap), one that becomes whole by a tiled
    ``all_gather``, one that becomes split is cut locally."""
    mesh = src.mesh
    for axis in MESH_AXES:
        d_src, d_dst = src.dim_of(axis), dst.dim_of(axis)
        if d_src == d_dst:
            continue
        if d_src is not None and d_dst is not None:
            x = all_to_all(x, axis, mesh, split_axis=d_dst, concat_axis=d_src)
        elif d_src is not None:
            x = all_gather(x, axis, mesh, axis=d_src, tiled=True)
        else:
            step = x.shape[d_dst] // mesh.shape[axis]
            x = x.narrow(d_dst, mesh.coords[axis] * step, step)
    return x


def assemble_rows(block: torch.Tensor, mesh: Mesh, axis: str = AXIS_SPACE, d: int = 1,
                  rows: int | None = None) -> np.ndarray:
    """The global (d*rows, k) matrix on this rank's host, from each rank's
    row block along ``axis`` (the counterpart of ``np.asarray`` on a JAX
    array sharded over rows): the blocks all-gathered in axis order, and
    for an interleaved Hankel block (d blocks of S_loc rows a rank,
    ``ops.hankel``) put delay-major (``dmd_era5_tpu/ops/hankel.py:356-360``);
    the zero padding past ``rows`` cut inside each delay block.  Every
    rank of the line calls it."""
    parts = all_gather(block, axis, mesh)  # (P, d*S_loc, k)
    n_shards, s_loc = parts.shape[0], parts.shape[1] // d
    out = parts.reshape(n_shards, d, s_loc, -1).transpose(0, 1).reshape(d, n_shards * s_loc, -1)
    rows = n_shards * s_loc if rows is None else rows
    return out[:, :rows].reshape(d * rows, -1).cpu().numpy()
