"""K2's route table and its kernels on thread-block clusters.

``sketch_center_gram`` (the first pass of the two-pass fallback, K2) runs
either on ``csrc/sketch_center_gram.cu`` -- two cluster kernels, the sketch
with X multicast to the CTAs that hold W's 64-column blocks, then G's
upper 128 x 64 blocks with each box of Yc multicast to the CTAs of a group
that read it -- or on K1's sketch and G stages
(``csrc/sketch_center_gram_project.cu`` and ``csrc/atb.cu``).  Which, is
:func:`k2_block`'s table, by shape and dtype alone; a build or launch error
raises, and nothing falls back.

Why the table sends what it sends (device ms on an NVIDIA H100 80GB HBM3 at
700 W, ``scripts/torch_k2_times.py``; PERF.md has the readings):

- bf16 X, W and Yc at N 257-512: the clusters.  At the d = 3 pass (X
  15,573,600 x 168, N 384) K1's stages read X three times in the sketch
  (three 128-wide CTA columns) and Yc about six times in G (twelve 128 x 64
  blocks, each re-reading 192 columns).
- N <= 256: K1's stages.  A bf16 sketch that narrow is K1's own route
  (``takes_two_pass``), and reaches K2 only past a time axis of 32,768.
- f32 X or an f32 Yc: K1's stages.  Their products are 3xTF32; the year's
  f32 N 256 and N 128 sketches are bound by those operations, not bytes.
- N or T no multiple of 8, an X whose base is not 16-byte aligned, or M
  past 2^31 - 1: K1's stages.  The clusters' copies and stores are TMA
  boxes of 16-byte rows with 32-bit coordinates.
- W's rows not held beside two of X's 16 KB slots (T past 1,280): K1's
  stages, which walk W in panels.
"""

from __future__ import annotations

import ctypes
import logging
from typing import NamedTuple

import torch

from dmd_era5_tpu_torch.ops._occupancy import SCRATCH_CAP

__all__ = ["K2Block", "k2_block", "gram_plan", "gram_boxes", "sketch_smem", "gram_smem",
           "GRAM_CLUSTER", "SMEM_CAP", "MAX_CLUSTER"]

logger = logging.getLogger(__name__)

SMEM_CAP = 232_448  # shared memory of one CTA
MAX_CLUSTER = 8  # a portable cluster: the kernels take no larger one
BN = 64  # Yc's columns a sketch CTA: one 128-byte box of bf16
N_MIN, N_MAX = 257, 512  # the clusters' widths: past K1's 256, to 8 x 64
MAX_RING = 8
_CHUNK = 128 * 128  # a sketch slot: 128 rows of 64 bf16 of X
_STAGE = 128 * BN * 2  # a tile of Yc staged for its store
_GBOX = 64 * 128  # a 64-column box of a 64-row Gram slab
_BARS = 2 * MAX_RING * 8
# The Gram's cluster: 2 CTAs at every width.  At the d = 3 pass (N 384)
# clusters of 2, 3, 4 and 6 read 13.95, 16.39, 14.72 and 18.47 ms on an H100
# 80GB HBM3 at 700 W (scripts/torch_k2_phases.py --gram-cluster; at N 512
# 2 and 4 read 25.09 and 25.00, at N 264 2 and 3 11.69 and 11.52): a larger
# cluster copies fewer boxes a slab (18 at 2 and 10 at 6, against the 36
# reads of K1's G stage), but its CTAs wait on one another more and fewer
# of them fit the card (132 CTAs at 2, 96 at 6).
GRAM_CLUSTER = 2


def sketch_smem(t: int, ring: int) -> int:
    """Shared memory of a sketch CTA (``csrc/sketch_center_gram.cu::
    sketch_smem``): the ring of X's chunks, W's 64 columns (T rounded up to
    64 rows, bf16), two staged tiles of Yc, the row means, the barriers."""
    return 1024 + ring * _CHUNK + -(-t // 64) * 64 * BN * 2 + 2 * _STAGE + 128 * 4 + _BARS


def gram_smem(n: int, ring: int) -> int:
    """Shared memory of a Gram CTA (``gram_smem``): ``ring`` slots of every
    64-column box of a 64-row slab of Yc, the barriers."""
    return 1024 + ring * -(-n // 64) * _GBOX + _BARS


def _upper_blocks(n: int) -> list[tuple[int, int]]:
    """G's 128 x 64 blocks (mi, ni) that hold an entry r <= c, row-major."""
    nbox = -(-n // 64)
    return [(mi, ni) for mi in range(-(-n // 128)) for ni in range(2 * mi, nbox)]


def gram_boxes(group: tuple[tuple[int, int], ...], n: int) -> dict[int, int]:
    """Yc's 64-column boxes that a group's CTAs read, each with the mask of
    the ranks that read it (an m side 2 mi and 2 mi + 1, an n side ni): one
    multicast copy a box and slab."""
    nbox = -(-n // 64)
    need: dict[int, int] = {}
    for rank, (mi, ni) in enumerate(group):
        if mi < 0:
            continue
        for k in {2 * mi, 2 * mi + 1, ni}:
            if k < nbox:
                need[k] = need.get(k, 0) | 1 << rank
    return need


def gram_plan(n: int, cluster: int) -> tuple[tuple[int, int], ...]:
    """G's upper 128 x 64 blocks (mi, ni), row-major, in groups of
    ``cluster`` CTAs, the last group padded with idle CTAs (-1, -1): rank r
    of cluster g computes entry g cluster + r."""
    blocks = _upper_blocks(n)
    pad = -len(blocks) % cluster
    return tuple(blocks) + ((-1, -1),) * pad


class K2Block(NamedTuple):
    """K2's route for one call: ``route`` "clusters" or "stages" (K1's
    sketch and G stages), ``why`` the table's reason; on the clusters, the
    sketch's cluster (64 columns of Yc a CTA), its ring of X's chunks and
    shared memory, and the Gram's cluster, its plan (block (mi, ni) a CTA,
    cluster after cluster), ring and shared memory."""

    route: str
    why: str
    sketch_cluster: int = 0
    sketch_ring: int = 0
    sketch_smem: int = 0
    gram_cluster: int = 0
    gram_plan: tuple = ()
    gram_ring: int = 0
    gram_smem: int = 0


def k2_block(m: int, t: int, n: int, x_dtype: torch.dtype, out_dtype: torch.dtype,
             base_aligned: bool = True) -> K2Block:
    """The table (this module's note has its reasons).  The Gram's ring and
    shared memory hang on N alone, so another Gram cluster ``cl`` is
    ``block._replace(gram_cluster=cl, gram_plan=gram_plan(n, cl))``
    (``scripts/torch_k2_phases.py --gram-cluster`` times the choices)."""
    bf16 = x_dtype == out_dtype == torch.bfloat16
    if not bf16:
        return K2Block("stages", "f32 X or Yc: 3xTF32 products, K1's stages")
    if not N_MIN <= n <= N_MAX:
        return K2Block("stages", f"N {n} outside the clusters' {N_MIN}-{N_MAX}")
    if n % 8 or t % 8 or not base_aligned or m > 0x7FFFFFFF:
        return K2Block("stages", "rows not 16-byte aligned or M past 2^31 - 1: no TMA boxes")
    sketch_ring = min(MAX_RING, (SMEM_CAP - sketch_smem(t, 0)) // _CHUNK)
    if sketch_ring < 2:
        return K2Block("stages", f"T {t}: W's rows not held beside two slots")
    gram_ring = min(MAX_RING, (SMEM_CAP - gram_smem(n, 0)) // (-(-n // 64) * _GBOX))
    return K2Block("clusters", "bf16 at N 257-512", -(-n // BN), sketch_ring,
                   sketch_smem(t, sketch_ring), GRAM_CLUSTER, gram_plan(n, GRAM_CLUSTER),
                   gram_ring, gram_smem(n, gram_ring))


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from dmd_era5_tpu_torch.ops._build import load_kernel_library

        _LIB = bind(load_kernel_library("sketch_center_gram"))
    return _LIB


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C interface of a build of ``csrc/sketch_center_gram.cu``, typed
    (``scripts/torch_k2_phases.py`` binds its variants' builds so)."""
    ptr, flag = ctypes.c_void_p, ctypes.c_int
    # x, w, colw, yc, stats, m, t, n, inv_t, cluster, ring, clusters, stream
    lib.k2c_sketch_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, flag, flag,
                                      ctypes.c_float, flag, flag, flag, ptr]
    lib.k2c_sketch_launch.restype = ctypes.c_int
    # yc, part, g, m, n, cluster, ring, n_share, plan, plan entries, stream
    lib.k2c_gram_launch.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, flag, flag, flag, flag,
                                    ptr, flag, ptr]
    lib.k2c_gram_launch.restype = ctypes.c_int
    # t or n, cluster, ring, &out
    for fn in (lib.k2c_sketch_clusters, lib.k2c_gram_clusters):
        fn.argtypes = [flag, flag, flag, ptr]
        fn.restype = ctypes.c_int
    return lib


_CLUSTERS: dict[tuple, int] = {}


def _active_clusters(dev, kind: str, width: int, cluster: int, ring: int) -> int:
    """Clusters of the sketch or Gram kernel resident on the card at once
    (the occupancy query), cached by device and instantiation."""
    key = (dev.index, kind, width, cluster, ring)
    if key not in _CLUSTERS:
        out = ctypes.c_int(0)
        fn = _library().k2c_sketch_clusters if kind == "sketch" else _library().k2c_gram_clusters
        with torch.cuda.device(dev):
            rc = fn(width, cluster, ring, ctypes.addressof(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(f"sketch_center_gram {kind} occupancy: CUDA error {rc}, "
                               f"{out.value} clusters of {cluster}")
        _CLUSTERS[key] = out.value
    return _CLUSTERS[key]


def gram_shares(m: int, n: int, groups: int, active: int) -> int:
    """Row shares of the Gram: the resident clusters over the block groups
    (one wave), at least 1, at most one a 128-row tile, their f64 scratch
    (N^2 doubles a share) within ``SCRATCH_CAP``."""
    return max(1, min(active // groups, -(-m // 128), SCRATCH_CAP // (8 * n * n), 65535))


def _plan_entries(gram_plan: tuple, cluster: int) -> list[int]:
    """The kernel's plan: mi << 8 | ni a CTA; an idle CTA shadows its
    cluster's first block (+ 1 << 16): it receives that block's boxes and
    computes it, so that it waits on the cluster's copies like the others
    (without, its warps ran ahead of the cluster and the barriers' phases
    no longer lined up), and writes nothing."""
    entries = []
    for i, (mi, ni) in enumerate(gram_plan):
        if mi < 0:
            fmi, fni = gram_plan[i - i % cluster]
            entries.append(1 << 16 | fmi << 8 | fni)
        else:
            entries.append(mi << 8 | ni)
    return entries


def plan(x: torch.Tensor, w: torch.Tensor, colw: torch.Tensor, inv_t: float,
         block: K2Block):
    """K2's outputs on the clusters, allocated (Yc bf16, the (M, 2)
    statistics, G, the Gram's f64 scratch; ``grid``: the sketch's clusters
    and the Gram's row shares), and ``run(mask)``, which
    launches the sketch (1) and the Gram with its reduction (2) into them.
    x (M, T) and w (T, N) bf16, contiguous; colw W's f32 column sums."""
    (m, t), n, dev = x.shape, w.shape[1], x.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(yc=torch.empty((m, n), dtype=torch.bfloat16, device=dev),
               stats=torch.empty((m, 2), **f32), g=torch.empty((n, n), **f32))
    sketch_clusters = min(_active_clusters(dev, "sketch", t, block.sketch_cluster,
                                           block.sketch_ring), -(-m // 128))
    groups = len(block.gram_plan) // block.gram_cluster
    n_share = gram_shares(m, n, groups, _active_clusters(dev, "gram", n, block.gram_cluster,
                                                         block.gram_ring))
    part = torch.empty((n_share, n, n), dtype=torch.float64, device=dev)
    out["grid"] = dict(sketch_clusters=sketch_clusters, gram_shares=n_share)
    entries = _plan_entries(block.gram_plan, block.gram_cluster)
    plan_arr = (ctypes.c_int * len(entries))(*entries)
    logger.debug("sketch_center_gram on clusters: %s, %d sketch clusters, %d row shares", block,
                 sketch_clusters, n_share)
    lib = _library()

    def run(mask: int) -> None:
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            if mask & 1:
                rc = lib.k2c_sketch_launch(
                    x.data_ptr(), w.data_ptr(), colw.data_ptr(), out["yc"].data_ptr(),
                    out["stats"].data_ptr(), m, t, n, inv_t, block.sketch_cluster,
                    block.sketch_ring, sketch_clusters, stream)
                if rc != 0:
                    raise RuntimeError(f"sketch_center_gram sketch kernel: CUDA error {rc}")
            if mask & 2:
                rc = lib.k2c_gram_launch(
                    out["yc"].data_ptr(), part.data_ptr(), out["g"].data_ptr(), m, n,
                    block.gram_cluster, block.gram_ring, n_share, ctypes.cast(plan_arr, ctypes.c_void_p),
                    len(entries), stream)
                if rc != 0:
                    raise RuntimeError(f"sketch_center_gram Gram kernel: CUDA error {rc}")

    return out, run
