"""Collectives along a named axis of a :class:`~parallel.mesh.Mesh`.

PyTorch counterpart of ``dmd_era5_tpu/parallel/collectives.py``: the
vocabulary the port's SPMD bodies are written in (psum / all-gather /
all-to-all / ring and general permutes), each acting on this rank's
local tensor over the process group of its line along ``axis_name``.
Every rank of the line calls each one, as every device of a
``shard_map`` body runs each ``lax`` collective.

Without a process group (one process) a collective is the identity; an
axis of more than one rank without a group raises.  Over gloo a tensor
on a card is staged through host memory (gloo's CUDA support differs
from one collective to the next), and the result comes back to the
card.  There is no fallback: a failed collective raises.

Every call is recorded in the open :func:`collective_log` contexts of
the process (op, axis, elements, bytes): the port's counterpart of
``tests/test_21_comm_pattern.py``'s count of collective payloads in the
compiled HLO.  ``elements`` is the size of the collective's result, as
that test reads it (for ``all_gather`` the gathered tensor).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Iterator

import torch
import torch.distributed as dist

from dmd_era5_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "CollectiveCall",
    "CollectiveLog",
    "collective_log",
    "psum",
    "pmean",
    "all_gather",
    "all_gather_packed",
    "axis_index",
    "axis_size",
    "ppermute",
    "ring_permute",
    "all_to_all",
    "halo_exchange_right",
    "halo_exchange_left",
]


@dataclass(frozen=True)
class CollectiveCall:
    op: str
    axis: str
    elements: int
    bytes: int


@dataclass
class CollectiveLog:
    """The collectives this process called while the log was open."""

    calls: list[CollectiveCall] = field(default_factory=list)

    def by_op(self) -> dict[str, dict[str, int]]:
        """op -> {"calls", "elements", "bytes"} summed over the calls."""
        out: dict[str, dict[str, int]] = {}
        for c in self.calls:
            row = out.setdefault(c.op, {"calls": 0, "elements": 0, "bytes": 0})
            row["calls"] += 1
            row["elements"] += c.elements
            row["bytes"] += c.bytes
        return out

    def count(self, op: str | None = None, axis: str | None = None) -> int:
        return sum(1 for c in self.calls
                   if (op is None or c.op == op) and (axis is None or c.axis == axis))

    def largest(self, axis: str | None = None) -> int:
        """The largest payload (elements) of a call, along ``axis`` if given."""
        return max((c.elements for c in self.calls if axis is None or c.axis == axis), default=0)


_OPEN_LOGS: list[CollectiveLog] = []


@contextlib.contextmanager
def collective_log() -> Iterator[CollectiveLog]:
    """Record every collective this process calls inside the block."""
    log = CollectiveLog()
    _OPEN_LOGS.append(log)
    try:
        yield log
    finally:
        _OPEN_LOGS.remove(log)


def _record(op: str, axis: str, out: torch.Tensor) -> None:
    call = CollectiveCall(op, axis, out.numel(), out.numel() * out.element_size())
    for log in _OPEN_LOGS:
        log.calls.append(call)


def axis_index(axis_name: str, mesh: Mesh) -> int:
    return mesh.coords[axis_name]


def axis_size(axis_name: str, mesh: Mesh) -> int:
    return mesh.shape[axis_name]


def _group(mesh: Mesh, axis_name: str):
    """The axis line's process group, or None (identity) for one process."""
    group = mesh.groups.get(axis_name)
    if group is None and mesh.shape[axis_name] > 1:
        raise RuntimeError(
            f"mesh axis {axis_name!r} spans {mesh.shape[axis_name]} ranks but this process "
            "has no process group; call initialize_distributed first"
        )
    return group


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """x where the backend takes it: the host for gloo, else where it lies."""
    if x.device.type != "cpu" and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def psum(x: torch.Tensor, axis_name: str, mesh: Mesh) -> torch.Tensor:
    """Sum of x over the ranks of this rank's line along ``axis_name``."""
    group = _group(mesh, axis_name)
    if group is None:
        return x
    buf = _staged(x, group)
    buf = buf.clone() if buf is x else buf
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    _record("psum", axis_name, buf)
    return buf.to(x.device)


def pmean(x: torch.Tensor, axis_name: str, mesh: Mesh) -> torch.Tensor:
    return psum(x, axis_name, mesh) / mesh.shape[axis_name]


def all_gather(x: torch.Tensor, axis_name: str, mesh: Mesh, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """The line's blocks in axis order, stacked on a new ``axis`` (or
    concatenated along it when ``tiled``)."""
    group = _group(mesh, axis_name)
    if group is None:
        return x if tiled else x.unsqueeze(axis)
    buf = _staged(x.contiguous(), group)
    parts = [torch.empty_like(buf) for _ in mesh.lines[axis_name]]
    dist.all_gather(parts, buf, group=group)
    # the group orders its members by global rank; the axis by the grid
    by_rank = dict(zip(sorted(mesh.lines[axis_name]), parts))
    parts = [by_rank[r] for r in mesh.lines[axis_name]]
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)
    _record("all_gather", axis_name, out)
    return out.to(x.device)


def all_gather_packed(tensors: list[torch.Tensor], axis_name: str, mesh: Mesh
                      ) -> list[torch.Tensor]:
    """``all_gather(t, axis_name, mesh, tiled=True)`` of each of ``tensors``
    in ONE call: each block, flattened past its leading dimension (all
    alike), goes as columns of one real tensor of the blocks' widest
    real dtype (a complex one as its real and imaginary parts, an
    integer one as floats: exact below 2^24), and comes back cut and in
    its own dtype and shape."""
    n = tensors[0].shape[0]
    parts = [torch.view_as_real(t) if t.is_complex() else t for t in tensors]
    dtype = torch.float32
    for part in parts:
        if part.is_floating_point():
            dtype = torch.promote_types(dtype, part.dtype)
    packed = torch.cat([part.reshape(n, -1).to(dtype) for part in parts], dim=1)
    packed = all_gather(packed, axis_name, mesh, tiled=True)
    out, c0 = [], 0
    for t, part in zip(tensors, parts):
        width = math.prod(part.shape[1:])
        block = packed[:, c0:c0 + width].reshape(-1, *part.shape[1:])
        c0 += width
        out.append(torch.view_as_complex(block.to(part.dtype).contiguous()) if t.is_complex()
                   else block.to(t.dtype))
    return out


def ppermute(x: torch.Tensor, axis_name: str, mesh: Mesh,
             perm: list[tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: the block of axis index ``src`` goes to ``dst``
    for each (src, dst) of ``perm``; a rank that is no destination gets
    zeros.  Point to point (``batch_isend_irecv``), never a gather."""
    group = _group(mesh, axis_name)
    me = mesh.coords[axis_name]
    line = mesh.lines[axis_name]
    send_to = [dst for src, dst in perm if src == me]
    recv_from = [src for src, dst in perm if dst == me]
    if group is None:
        return x.clone() if recv_from else torch.zeros_like(x)
    buf = _staged(x.contiguous(), group)
    out = torch.zeros_like(buf)
    ops = [dist.P2POp(dist.isend, buf, line[dst], group) for dst in send_to if dst != me]
    ops += [dist.P2POp(dist.irecv, out, line[src], group) for src in recv_from if src != me]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if me in send_to and me in recv_from:
        out.copy_(buf)
    _record("ppermute", axis_name, out)
    return out.to(x.device)


def ring_permute(x: torch.Tensor, axis_name: str, mesh: Mesh, shift: int = 1) -> torch.Tensor:
    """Send the local block to the neighbour ``shift`` steps along the
    ring: block i receives block i - shift."""
    n = mesh.shape[axis_name]
    return ppermute(x, axis_name, mesh, [(i, (i + shift) % n) for i in range(n)])


def all_to_all(x: torch.Tensor, axis_name: str, mesh: Mesh, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Ulysses-style reshard (tiled): x split into the line's size of
    pieces along ``split_axis``, piece j to axis index j, the pieces
    received concatenated along ``concat_axis`` in axis order."""
    group = _group(mesh, axis_name)
    if group is None:
        return x
    line = mesh.lines[axis_name]
    buf = _staged(x, group)
    pieces = [p.contiguous() for p in buf.chunk(len(line), dim=split_axis)]
    if len({p.shape for p in pieces}) != 1 or len(pieces) != len(line):
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not split over "
                         f"{len(line)} ranks")
    # the group's ranks are its members in global-rank order
    order = sorted(line)
    send = [pieces[line.index(r)] for r in order]
    recv = [torch.empty_like(pieces[0]) for _ in order]
    dist.all_to_all(recv, send, group=group)
    by_rank = dict(zip(order, recv))
    out = torch.cat([by_rank[r] for r in line], dim=concat_axis)
    _record("all_to_all", axis_name, out)
    return out.to(x.device)


def halo_exchange_right(x: torch.Tensor, axis_name: str, mesh: Mesh, halo: int,
                        axis: int = -1) -> torch.Tensor:
    """Append the first ``halo`` slices of the right neighbour's block;
    the last rank of the line appends zeros (past-the-end windows the
    caller trims)."""
    axis = axis % x.ndim
    received = ring_permute(x.narrow(axis, 0, halo), axis_name, mesh, shift=-1)
    if mesh.coords[axis_name] == mesh.shape[axis_name] - 1:
        received = torch.zeros_like(received)
    return torch.cat([x, received], dim=axis)


def halo_exchange_left(x: torch.Tensor, axis_name: str, mesh: Mesh, halo: int,
                       axis: int = -1) -> torch.Tensor:
    """Prepend the last ``halo`` slices of the left neighbour's block; the
    first rank of the line prepends zeros (trimmed by the caller)."""
    axis = axis % x.ndim
    tail = x.narrow(axis, x.shape[axis] - halo, halo)
    received = ring_permute(tail, axis_name, mesh, shift=1)
    if mesh.coords[axis_name] == 0:
        received = torch.zeros_like(received)
    return torch.cat([received, x], dim=axis)
