"""The (data, space, time) mesh of ranks on ``torch.distributed``.

PyTorch counterpart of ``dmd_era5_tpu/parallel/mesh.py``.  The port is
SPMD: one process per rank, each holding its LOCAL block and calling
explicit collectives (:mod:`parallel.collectives`) where the JAX package
writes ``shard_map`` bodies.  A :class:`Mesh` is the grid of ranks with
up to three named axes:

- ``space``: row-sharding of the snapshot matrix (the tall-skinny GEMM
  and TSQR workhorse);
- ``time``: column-sharding for long time ranges (halo exchange and the
  all-to-all reshard live here);
- ``data``: batches of independent decompositions.

Axes of size one are always present.  The rank grid is the JAX device
grid index for index (ranks in the place of devices), the hybrid mesh's
DCN-major interleave included, so the same shape puts the same block on
rank i as on device i.

Backend: NCCL where every rank of the host owns a CUDA card of its own
(a one-rank group too), gloo where ranks share a card or run on the CPU
(NCCL refuses two ranks on one card).  The chosen backend is logged.
There is no fallback: a failed initialisation raises, and a mesh is on
the CPU only when the caller asks for it.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "AXIS_DATA",
    "AXIS_SPACE",
    "AXIS_TIME",
    "MESH_AXES",
    "Mesh",
    "initialize_distributed",
    "parse_mesh_shape",
    "make_mesh",
    "single_device_mesh",
    "mesh_from_config",
    "make_hybrid_mesh",
]

logger = logging.getLogger(__name__)

AXIS_DATA = "data"
AXIS_SPACE = "space"
AXIS_TIME = "time"
MESH_AXES = (AXIS_DATA, AXIS_SPACE, AXIS_TIME)

# Environment markers of a managed multi-process launch whose rank and
# world size this module reads (the JAX package's TPU-pod markers are
# TPU-only and dropped): variable with the world size, with the rank.
_CLUSTER_ENV_MARKERS = {
    "SLURM_JOB_ID": ("SLURM_NTASKS", "SLURM_PROCID"),
    "OMPI_COMM_WORLD_SIZE": ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"),
}


def _tasks_on_node(spec: str, node: int) -> int:
    """Node ``node``'s task count in SLURM's ``SLURM_TASKS_PER_NODE``
    (``"4(x2),3"``: 4 on each of two nodes, then 3)."""
    counts = []
    for part in spec.split(","):
        n, _, repeat = part.partition("(x")
        counts += [int(n)] * int(repeat.rstrip(")") or 1)
    return counts[node]


def _local_layout(world_size: int, rank: int) -> tuple[int, int]:
    """(this host's rank count, this rank's place among them), from the
    launcher: torchrun's ``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK``, SLURM's
    ``SLURM_TASKS_PER_NODE`` (this ``SLURM_NODEID``'s entry) /
    ``SLURM_LOCALID``, OpenMPI's ``OMPI_COMM_WORLD_LOCAL_SIZE`` /
    ``OMPI_COMM_WORLD_LOCAL_RANK``; else every rank on this host."""
    env = os.environ
    if env.get("LOCAL_WORLD_SIZE") or env.get("LOCAL_RANK"):
        return int(env.get("LOCAL_WORLD_SIZE", world_size)), int(env.get("LOCAL_RANK", rank))
    if env.get("SLURM_LOCALID") and env.get("SLURM_TASKS_PER_NODE"):
        node = int(env.get("SLURM_NODEID", 0))
        return _tasks_on_node(env["SLURM_TASKS_PER_NODE"], node), int(env["SLURM_LOCALID"])
    if env.get("OMPI_COMM_WORLD_LOCAL_SIZE"):
        return (int(env["OMPI_COMM_WORLD_LOCAL_SIZE"]),
                int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", rank)))
    return world_size, rank


def _choose_backend(device: str | None, local_ranks: int) -> str:
    """``"gloo"`` on the CPU or where this host's ranks outnumber its
    cards, else ``"nccl"``; raises where a card is wanted and none is."""
    if device == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the mesh runs on CUDA cards and none is available; pass device='cpu' "
            "to run its ranks on the host"
        )
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device: str | None = None,
    timeout_s: float = 300.0,
) -> str | None:
    """Join this process to its multi-process group; return the backend.

    Resolution order (nothing to do, None returned, if a group is up):

    1. an explicit ``init_method`` (``file://`` for the tests,
       ``tcp://host:port``) with ``world_size`` and ``rank``;
    2. torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
       ``RANK`` (``env://``);
    3. a SLURM or OpenMPI launch (its markers), with ``MASTER_ADDR`` and
       ``MASTER_PORT`` naming rank 0's host and a free port;
    4. otherwise a single process: nothing to do.

    The backend follows the layout (module docstring); ``device="cpu"``
    asks for the host.  The launcher's local variables count this host's
    ranks and give this one's place among them (:func:`_local_layout`;
    without them all ranks are taken to share the host).  On NCCL each
    rank's card is made the current one before the group starts.
    """
    if dist.is_initialized():
        return None
    env = os.environ
    if init_method is None:
        marker = next((m for m in _CLUSTER_ENV_MARKERS if env.get(m)), None)
        if env.get("MASTER_ADDR") and env.get("WORLD_SIZE") and env.get("RANK"):
            world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        elif marker is not None:
            size_var, rank_var = _CLUSTER_ENV_MARKERS[marker]
            if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
                raise RuntimeError(
                    f"a {marker} launch needs MASTER_ADDR and MASTER_PORT (rank 0's host "
                    "and a free port) to start the process group"
                )
            world_size, rank = int(env[size_var]), int(env[rank_var])
        else:
            return None
        init_method = "env://"
    if world_size is None or rank is None:
        raise ValueError("an explicit init_method needs world_size and rank")
    local_ranks, local_rank = _local_layout(world_size, rank)
    backend = _choose_backend(device, local_ranks)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    logger.info("rank %d of %d joined over %s (%s; %d ranks on this host, %d cards)",
                rank, world_size, backend, init_method.split("://")[0], local_ranks, cards)
    return backend


def parse_mesh_shape(spec: str | Mapping[str, int] | None) -> dict[str, int] | None:
    """Parse a mesh-shape spec like ``"space=4,time=2"`` into a dict.

    ``None`` / ``"auto"`` return None (auto layout).
    """
    if spec is None or spec == "auto":
        return None
    if isinstance(spec, Mapping):
        shape = dict(spec)
    else:
        shape = {}
        for part in spec.split(","):
            name, _, value = part.partition("=")
            name = name.strip()
            if name not in MESH_AXES:
                raise ValueError(f"Unknown mesh axis {name!r}; supported axes: {MESH_AXES}")
            shape[name] = int(value)
    for name, size in shape.items():
        if size < 1:
            raise ValueError(f"Mesh axis {name} must be >= 1, got {size}")
    return shape


@dataclass
class Mesh:
    """This rank's view of a (data, space, time) grid of ranks.

    ``shape``: axis -> size; ``ranks``: the (data, space, time) grid of
    global ranks; ``rank`` and ``coords`` (axis -> index): this process's
    place; ``device``: where its blocks live; ``groups``: axis -> the
    process group of this rank's line along the axis, and ``lines``:
    axis -> that line's global ranks in axis order.  Without a process
    group (one process) ``groups`` is empty and every collective is the
    identity.
    """

    shape: dict[str, int]
    ranks: np.ndarray
    rank: int
    coords: dict[str, int]
    device: torch.device
    groups: dict[str, object] = field(default_factory=dict)
    lines: dict[str, list[int]] = field(default_factory=dict)


def _mesh_device(device: str | torch.device | None) -> torch.device:
    """The card this rank computes on (``cuda:<local rank>`` when each rank
    has one, ``cuda:0`` when they share it), or the device asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the mesh runs on CUDA cards and none is available; pass device='cpu' "
            "to build it on the host"
        )
    world = dist.get_world_size() if dist.is_initialized() else 1
    _, local = _local_layout(world, dist.get_rank() if dist.is_initialized() else 0)
    return torch.device("cuda", local % torch.cuda.device_count())


def _resolve_sizes(parsed: dict[str, int] | None, total: int, default_axis: str) -> dict[str, int]:
    """Axis sizes over ``total`` ranks: auto puts all on ``default_axis``;
    unspecified axes are 1, ``default_axis`` (else the first unspecified
    one) absorbing the remainder (``dmd_era5_tpu/parallel/mesh.py:136-152,
    :205-229``)."""
    if parsed is None:
        out = {axis: 1 for axis in MESH_AXES}
        out[default_axis] = total
        return out
    out = {axis: parsed.get(axis, 0) for axis in MESH_AXES}
    known = math.prod(s for s in out.values() if s > 0)
    if total % known:
        raise ValueError(f"Mesh shape {parsed} incompatible with {total} devices")
    rem = total // known
    missing = [axis for axis, s in out.items() if s == 0]
    for axis in missing:
        out[axis] = 1
    if missing and rem > 1:
        out[default_axis if default_axis in missing else missing[0]] = rem
    if math.prod(out.values()) != total:
        raise ValueError(f"Mesh shape {out} does not cover {total} devices")
    return out


def _build(grid: np.ndarray, device: str | torch.device | None) -> Mesh | None:
    """The :class:`Mesh` of ``grid`` for this process, with one process
    group per line of every axis.  Every rank of the world calls this (as
    ``new_group`` requires); a rank outside the grid gets None."""
    grid = np.asarray(grid, dtype=np.int64)
    me = dist.get_rank() if dist.is_initialized() else int(grid.flat[0])
    groups, lines = {}, {}
    for a, axis in enumerate(MESH_AXES):
        moved = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
        for line in moved.tolist():
            group = dist.new_group(ranks=line) if dist.is_initialized() else None
            if me in line:
                groups[axis], lines[axis] = group, line
    where = np.argwhere(grid == me)
    if len(where) == 0:
        return None
    coords = dict(zip(MESH_AXES, (int(i) for i in where[0])))
    mesh_device = _mesh_device(device)
    if dist.is_initialized():
        # NCCL takes a batch of point-to-point ops among some of a group's
        # ranks only after the group's first collective: one all-reduce
        # of one element a group here, in axis order on every rank
        for axis in MESH_AXES:
            if dist.get_backend(groups[axis]) == "nccl":
                dist.all_reduce(torch.zeros(1, device=mesh_device), group=groups[axis])
    return Mesh(
        shape=dict(zip(MESH_AXES, (int(n) for n in grid.shape))), ranks=grid, rank=me,
        coords=coords, device=mesh_device,
        groups=groups if dist.is_initialized() else {}, lines=lines,
    )


def _world_ranks(ranks: Sequence[int] | None) -> list[int]:
    if ranks is not None:
        return list(ranks)
    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


def make_mesh(
    shape: str | Mapping[str, int] | None = None,
    ranks: Sequence[int] | None = None,
    device: str | torch.device | None = None,
) -> Mesh | None:
    """Build a (data, space, time) mesh over the ranks (default: the world).

    Auto layout puts every rank on ``space``; an explicit shape must
    multiply to the rank count, unspecified axes default to 1 and
    ``space`` absorbs the remainder, as in the JAX package.  Every rank
    of the world calls it; a rank outside ``ranks`` gets None.
    ``device``: where this rank's blocks live (default: its card).
    """
    ranks = _world_ranks(ranks)
    sizes = _resolve_sizes(parse_mesh_shape(shape), len(ranks), AXIS_SPACE)
    grid = np.asarray(ranks).reshape([sizes[a] for a in MESH_AXES])
    return _build(grid, device)


def single_device_mesh(device: str | torch.device | None = None) -> Mesh:
    """A (1, 1, 1) mesh of this process alone, with no process group: its
    collectives are the identity."""
    me = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(shape={axis: 1 for axis in MESH_AXES}, ranks=np.full((1, 1, 1), me),
                rank=me, coords={axis: 0 for axis in MESH_AXES},
                device=_mesh_device(device), lines={axis: [me] for axis in MESH_AXES})


def mesh_from_config(parsed_config: Mapping[str, object],
                     device: str | torch.device | None = None) -> Mesh | None:
    """The stage mesh from parsed config fields: ``mesh_shape`` gives the
    intra-host factors; a non-None ``dcn_mesh_shape`` routes to
    :func:`make_hybrid_mesh`."""
    ici = parsed_config.get("mesh_shape", "auto")
    dcn = parsed_config.get("dcn_mesh_shape", None)
    if dcn is None:
        return make_mesh(ici, device=device)  # type: ignore[arg-type]
    return make_hybrid_mesh(ici, dcn, device=device)  # type: ignore[arg-type]


def make_hybrid_mesh(
    ici_shape: str | Mapping[str, int] | None = None,
    dcn_shape: str | Mapping[str, int] | None = None,
    ranks: Sequence[int] | None = None,
    n_slices: int | None = None,
    device: str | torch.device | None = None,
) -> Mesh | None:
    """A (data, space, time) mesh spanning several hosts.

    Each axis combines an outer factor across hosts (``dcn_shape``; the
    JAX package's DCN between TPU slices) with an inner one within a host
    (``ici_shape``), DCN-major: a shard index along an axis first selects
    the host, then the rank within it.  Defaults: ``data`` spans hosts
    (only scalar losses cross it), ``space`` takes each host's ranks.

    ``n_slices`` splits the ranks into that many contiguous equal groups
    (the tests' virtual hosts); by default a group is a host's ranks, as
    many as the launcher says (:func:`_local_layout`; all ranks without it).
    """
    ranks = _world_ranks(ranks)
    if n_slices is None:
        n_slices = len(ranks) // _local_layout(len(ranks), 0)[0]
    if n_slices < 1 or len(ranks) % n_slices:
        raise ValueError(f"{len(ranks)} devices not divisible into {n_slices} slices")
    per = len(ranks) // n_slices
    groups = [ranks[i * per : (i + 1) * per] for i in range(n_slices)]
    dcn = _resolve_sizes(parse_mesh_shape(dcn_shape), len(groups), AXIS_DATA)
    ici = _resolve_sizes(parse_mesh_shape(ici_shape), per, AXIS_SPACE)
    # (Dd, Ds, Dt, Id, Is, It) -> interleave DCN-major per axis
    grid = np.asarray(
        [np.asarray(g).reshape([ici[a] for a in MESH_AXES]) for g in groups]
    ).reshape([dcn[a] for a in MESH_AXES] + [ici[a] for a in MESH_AXES])
    grid = grid.transpose(0, 3, 1, 4, 2, 5).reshape([dcn[a] * ici[a] for a in MESH_AXES])
    return _build(grid, device)
