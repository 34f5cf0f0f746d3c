"""The fused sketch / centre / Gram / projection pass over X, its
two-pass fallback, and the tiled matmul of the streamed sketch.

PyTorch counterpart of ``dmd_era5_tpu/ops/matmul.py::
sketch_center_gram_project``.  From ONE read of the snapshot matrix
X (M, T) and a sketch W (T, N) it returns

    Yc = X W - (rowsum / t_valid) colsum(W)      stored in ``out_dtype``
    rowsum, rowsumsq                             (or their two scalar sums)
    G  = Yc^T Yc,   C = Yc^T X                   both from the STORED Yc

Where the JAX package's fused kernel cannot take the time axis, and
where the port's fused kernel cannot take the sketch's width
(:func:`takes_two_pass`), the same outputs come from two passes,
:func:`sketch_center_gram` then :func:`project`, as in the JAX package.
Also ``dmd_era5_tpu/ops/matmul.py::matmul``: (M, K) @ (K, N) summed in
f32, the per-block sketch of the out-of-core SVD.

On a CUDA tensor each wrapper launches its hand-written Hopper kernels
(K1: ``csrc/sketch_center_gram_project.cu``'s sketch stage, then its G
stage on ``csrc/atb.cu`` through ``ops/atb.py`` and its C stage on K3's
``csrc/project.cu``; K2 on the cluster kernels of
``csrc/sketch_center_gram.cu`` or K1's sketch and G stages, by
``ops/k2.py``'s table; ``csrc/project.cu`` K3, ``csrc/matmul.cu`` K6); on a CPU tensor it
takes the plain PyTorch version beside it, which does the same
arithmetic with ``torch.matmul``.  There is no fallback between the two:
which pass runs is decided by the shapes alone, the same on both.
"""

from __future__ import annotations

import ctypes
import logging
from typing import NamedTuple

import torch

from dmd_era5_tpu_torch.ops import atb, k2
from dmd_era5_tpu_torch.ops._occupancy import resident_ctas, wave_row_shares

__all__ = [
    "sketch_center_gram_project",
    "sketch_center_gram",
    "project",
    "project_block",
    "ProjectBlock",
    "takes_two_pass",
    "matmul",
    "matmul_block",
    "MatmulBlock",
    "N_MAX",
    "SKETCH_N_MAX",
]

logger = logging.getLogger(__name__)

# Widest sketch of the fused kernel K1, as the JAX package's fused kernel
# (dmd_era5_tpu/ops/matmul.py:263: N <= 256).  Wider ones take the two-pass
# route.  K1 takes any T: its f64 row-share scratch, N (N + T) doubles a
# share, stays within 1 GiB.
N_MAX = 256
# Widest sketch of K2, whose Gram stage keeps n_share * N^2 f64 partials.
SKETCH_N_MAX = 2048
_DTYPES = (torch.float32, torch.bfloat16)
# The JAX package's X-tile budget by itemsize (dmd_era5_tpu/ops/matmul.py:
# 331), which sets where it leaves its fused kernel for the two passes.
_TILE_BUDGET = {2: 2 << 20, 4: 1 << 20}
_PLAIN_CHUNK = 1 << 28  # bytes of f32 rows a plain version takes at once


def _long_time_axis(t_cols: int, itemsize: int) -> bool:
    """Where the JAX package's fused kernel cannot hold one 128-row tile
    of X: 128 T itemsize > 4 x its tile budget, i.e. T > 8,192 in f32 and
    T > 32,768 in bf16 (``dmd_era5_tpu/ops/matmul.py:374``)."""
    return 128 * t_cols * itemsize > 4 * _TILE_BUDGET[itemsize]


def takes_two_pass(t_cols: int, n: int, itemsize: int) -> bool:
    """Whether :func:`sketch_center_gram_project` takes the two passes:
    where the JAX package does (:func:`_long_time_axis`), and where K1
    cannot go, a sketch wider than ``N_MAX``."""
    return _long_time_axis(t_cols, itemsize) or n > N_MAX


def _row_slices(x: torch.Tensor):
    """Row slices of x of about ``_PLAIN_CHUNK`` bytes in f32, so a plain
    version never builds an f32 temporary of all of x's rows."""
    rows = max(1, _PLAIN_CHUNK // (4 * max(1, x.shape[1])))
    return [slice(r, min(r + rows, x.shape[0])) for r in range(0, x.shape[0], rows)]


def _row_sumsq(x: torch.Tensor, square_in_storage: bool = False) -> torch.Tensor:
    """sum_t x^2 per row in f32, row chunk by row chunk; the square is
    rounded to x's dtype first with ``square_in_storage``."""
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for sl in _row_slices(x):
        xc = x[sl]
        out[sl] = ((xc * xc).float() if square_in_storage else xc.float().square()).sum(dim=1)
    return out


def _prepare(w, t_cols, center, stats_col, t_valid):
    """(W with the stats column set, f32 column sums of W, 1/t_valid)."""
    if stats_col:
        w = w.clone()
        w[:, -1] = 1.0
        if t_valid is not None:
            # zero-pad rows of the ones column would count the padded
            # columns in colsum(W); zero them so the stats column of Yc
            # cancels exactly (dmd_era5_tpu/ops/matmul.py:315-325)
            w[t_valid:, -1] = 0.0
    colw = w.float().sum(dim=0)
    t_true = t_valid if t_valid is not None else t_cols
    inv_t = (1.0 / t_true) if center else 0.0
    return w.contiguous(), colw, inv_t


def _check_operands(x, w, out_dtype):
    """x (M, K) and w (K, N), non-empty, of one dtype and device."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x (M, K) and w (K, N); got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(
            f"x and w must share one dtype of {_DTYPES}; got {x.dtype}, {w.dtype}"
        )
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype must be one of {_DTYPES}, got {out_dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if min(*x.shape, w.shape[1]) < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, w {tuple(w.shape)}")


def _check(x, w, out_dtype, t_valid):
    _check_operands(x, w, out_dtype)
    t_cols = w.shape[0]
    if t_valid is not None and not 0 < t_valid <= t_cols:
        raise ValueError(f"t_valid={t_valid} outside (0, {t_cols}]")


def _sketch_center_gram_project_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
    center: bool = True,
    stats_col: bool = False,
    scalar_stats: bool = False,
    t_valid: int | None = None,
    emit_yc: bool = True,
):
    """Plain PyTorch version of the kernel: same flags, same outputs.

    f32 products (run with TF32 off on a card), with Yc quantized to
    ``out_dtype`` before G and C are formed from it.  Over millions of
    rows its f32 sums are less accurate than the kernel's, whose tile
    sums accumulate in f64.
    """
    _check(x, w, out_dtype, t_valid)
    w, colw, inv_t = _prepare(w, x.shape[1], center, stats_col, t_valid)
    xf = x.float()
    y = xf @ w.float()
    if stats_col:
        # the ones column gives the pre-centering row sum; the square
        # is taken in the storage dtype, summed in f32
        rs = y[:, -1].clone()
        ssq = _row_sumsq(x, square_in_storage=True)
    else:
        rs = xf.sum(dim=1)
        ssq = _row_sumsq(x)
    # in place, which saves one (M, N) f32 copy (16 GB at ERA5 size)
    yc = y.sub_((rs * inv_t)[:, None] * colw[None, :]).to(out_dtype)
    ycf = yc.float()
    g = ycf.T @ ycf
    c = ycf.T @ xf
    yc_out = yc if emit_yc else None
    if scalar_stats:
        return yc_out, (rs * rs).sum(), ssq.sum(), g, c
    return yc_out, rs, ssq, g, c


_LIB = None
_STAGES = 7  # K1's sketch, G and C stages (bits 0-2 of _scgp_plan's run mask)
_K2_STAGES = 3  # K2: the sketch and G stages


def _kernel_library():
    global _LIB
    if _LIB is None:
        from dmd_era5_tpu_torch.ops._build import load_kernel_library

        lib = load_kernel_library("sketch_center_gram_project")
        ptr, flag = ctypes.c_void_p, ctypes.c_int
        lib.scgp_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,  # x, w, W's split chunks, colw, yc, stats
            ptr, ptr,  # scalar stats: per-CTA f64 sums, reduced
            ctypes.c_longlong, flag, flag,  # m, t, n
            flag, flag, flag, ctypes.c_float,  # x_bf16, out_bf16, stats_col, inv_t
            flag, flag, flag, flag, flag,  # the sketch's block: width, copy path, kw, ring, stream
            flag, ptr,  # the sketch's CTAs, stream
        ]
        lib.scgp_launch.restype = ctypes.c_int
        # x_bf16, the sketch's block (width, copy path, W streamed, shared memory), &out
        lib.scgp_sketch_ctas_per_sm.argtypes = [flag, flag, flag, flag, flag, ptr]
        lib.scgp_sketch_ctas_per_sm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _sketch_wave(dev, x_bf16: int, block: MatmulBlock) -> int:
    """CTAs of K1's sketch stage in ``block`` resident on the card at once."""
    return resident_ctas(
        dev, ("sketch_center_gram_project", 0, x_bf16, block),
        lambda out: _kernel_library().scgp_sketch_ctas_per_sm(
            x_bf16, block.n, _MM_LOADS.index(block.load), int(block.stream), block.smem, out),
    )


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _scgp_plan(x, w, out_dtype, center, stats_col, scalar_stats, t_valid, emit_yc,
               stages=_STAGES):
    """The outputs of the stages in ``stages`` (1 sketch, 2 G = Yc^T Yc,
    4 C = Yc^T X: 7 for K1, 3 for K2), allocated, and ``run(mask)``, which
    launches the stages in the mask into them.  Yc is allocated as scratch
    where ``emit_yc`` is off: G and C are read from it.  The sketch runs on
    the card's resident CTAs in :func:`matmul_block`'s block (its columns
    a CTA, copy path, ring and whether it streams W: W's split chunks then
    take scratch); G on ``csrc/atb.cu`` in ``ops/atb.py``'s block, C on
    K3's kernel in :func:`project_block`'s (the hourly year's as the two
    passes take it), each on the row shares that fill whole waves over its
    blocks, its f64 scratch within 1 GiB."""
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major M x T)")
    w, colw, inv_t = _prepare(w, x.shape[1], center, stats_col, t_valid)
    (m, t_cols), n, dev = x.shape, w.shape[1], x.device
    x_bf16, out_bf16 = int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16)
    block = matmul_block(m, t_cols, n, x.dtype, center=True, base_aligned=x.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        wave = _sketch_wave(dev, x_bf16, block) if stages & 1 else 0
    f32, f64 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.float64, device=dev)
    out = dict(
        yc=torch.empty((m, n), dtype=out_dtype, device=dev),
        stats=None if scalar_stats else torch.empty((m, 2), **f32),
        st=torch.empty(2, **f32) if scalar_stats else None,
        g=None,
        c=None,
    )
    st_part = torch.empty((wave, 2), **f64) if scalar_stats else None
    # where the sketch streams W (long f32 time axes), W split into tf32 chunks
    w_split = (torch.empty(_mm_w_stream_bytes(t_cols, n), dtype=torch.uint8, device=dev)
               if block.stream else None)
    g_block = atb.gram_block(n, out_dtype, m)
    c_block = project_block(m, n, t_cols, out_dtype, x.dtype)
    logger.debug("sketch_center_gram_project: sketch %s on %d CTAs; G %s; C %s", block, wave,
                 g_block, c_block)

    def run(stages: int) -> None:
        if stages & 1:
            with torch.cuda.device(dev):
                rc = _kernel_library().scgp_launch(
                    _ptr(x), _ptr(w), _ptr(w_split), _ptr(colw), _ptr(out["yc"]),
                    _ptr(out["stats"]), _ptr(st_part), _ptr(out["st"]), m, t_cols, n, x_bf16,
                    out_bf16, int(stats_col), inv_t, block.n, _MM_LOADS.index(block.load),
                    block.panel, block.stages, int(block.stream), wave,
                    torch.cuda.current_stream(dev).cuda_stream,
                )
            if rc != 0:
                raise RuntimeError(f"sketch_center_gram_project kernel: CUDA error {rc}")
        if stages & 2:
            out["g"] = atb.gram_cuda(out["yc"], g_block)
        if stages & 4:
            out["c"] = _project_launch(x, out["yc"], c_block)

    return out, run


def _sketch_center_gram_project_cuda(
    x, w, out_dtype, center, stats_col, scalar_stats, t_valid, emit_yc
):
    out, run = _scgp_plan(x, w, out_dtype, center, stats_col, scalar_stats, t_valid, emit_yc)
    run(_STAGES)
    # the scratch (and Yc without emit_yc) is released on return while the
    # kernels may still run: the caching allocator hands its memory only to
    # later work on this same stream, which runs after them
    sketch_center_gram_project.launches += 1
    yc = out["yc"] if emit_yc else None
    if scalar_stats:
        return yc, out["st"][0], out["st"][1], out["g"], out["c"]
    return yc, out["stats"][:, 0], out["stats"][:, 1], out["g"], out["c"]


def sketch_center_gram_project(
    x: torch.Tensor,
    w: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
    center: bool = True,
    stats_col: bool = False,
    scalar_stats: bool = False,
    t_valid: int | None = None,
    emit_yc: bool = True,
):
    """Fused single-pass (Yc, rowsum, rowsumsq, G, C) from one read of X.

    x: (M, T); w: (T, N), both float32 or both bfloat16.  Returns
    (Yc (M, N) ``out_dtype`` or None when ``emit_yc=False``, rowsum (M,)
    f32, rowsumsq (M,) f32, G (N, N) f32, C (N, T) f32).

    ``center=False`` skips the rank-1 mean correction.  ``stats_col``
    replaces w's last column with ones so the row sum comes out of the
    sketch product.  ``scalar_stats`` returns sum(rowsum^2) and
    sum(rowsumsq) in place of the two vectors.  ``t_valid``: the
    trailing T - t_valid columns of x are zero padding; only the
    centering divisor uses the true count.

    Where :func:`takes_two_pass` says so, the outputs come from
    :func:`sketch_center_gram` then :func:`project` (kernels K2 and K3),
    with the JAX package's fallback semantics: the row statistics from
    the f32 values of X (not from the stats column, whose ones still
    enter W), ``scalar_stats`` summed from them, and Yc computed even
    when ``emit_yc=False``.  A ``t_valid`` below T raises where the JAX
    package's fallback raises, on a time axis too long for its fused
    kernel; a sketch too wide for K1 alone keeps it.

    A CPU tensor takes the plain PyTorch versions; a CUDA tensor launches
    the Hopper kernels and counts each launch in the wrapper's
    ``launches`` (``sketch_center_gram_project.launches`` for K1).
    """
    _check(x, w, out_dtype, t_valid)
    args = (out_dtype, center, stats_col, scalar_stats, t_valid, emit_yc)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    if takes_two_pass(w.shape[0], w.shape[1], x.element_size()):
        return _two_pass(x, w, *args)
    if x.device.type == "cpu":
        return _sketch_center_gram_project_plain(x, w, *args)
    return _sketch_center_gram_project_cuda(x, w, *args)


def _two_pass(x, w, out_dtype, center, stats_col, scalar_stats, t_valid, emit_yc):
    """``dmd_era5_tpu/ops/matmul.py:374-387``: K2 then K3."""
    t_cols = x.shape[1]
    if t_valid not in (None, t_cols) and _long_time_axis(t_cols, x.element_size()):
        raise ValueError(
            "t_valid column padding needs the fused single-pass kernel; time "
            f"axis {t_cols} is too long for it (the JAX package's fallback "
            "refuses it too)"
        )
    w, _, _ = _prepare(w, t_cols, center, stats_col, t_valid)
    yc, rs, ss, g = sketch_center_gram(x, w, out_dtype=out_dtype, center=center, t_valid=t_valid)
    c = project(x, yc)
    yc_out = yc if emit_yc else None
    if scalar_stats:
        return yc_out, (rs * rs).sum(), ss.sum(), g, c
    return yc_out, rs, ss, g, c


sketch_center_gram_project.launches = 0


# ------------------------------------------------- the two-pass fallback


def _check_sketch(x, w, out_dtype, t_valid):
    _check_operands(x, w, out_dtype)
    if w.shape[1] > SKETCH_N_MAX:
        raise ValueError(
            f"sketch width {w.shape[1]} is outside the range of the "
            f"sketch_center_gram kernel (max {SKETCH_N_MAX}, its Gram scratch)"
        )
    if t_valid is not None and not 0 < t_valid <= w.shape[0]:
        raise ValueError(f"t_valid={t_valid} outside (0, {w.shape[0]}]")


def _sketch_center_gram_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
    center: bool = True,
    t_valid: int | None = None,
):
    """Plain PyTorch version of K2: the same outputs from f32 products
    (TF32 off on a card), X and the stored Yc taken in row chunks, so no
    (M, T) or (M, N) f32 temporary is built; G from the stored Yc in f32
    sums (the kernel's sums are f64-grade)."""
    _check_sketch(x, w, out_dtype, t_valid)
    wf = w.float()
    colw = wf.sum(dim=0)
    inv_t = (1.0 / (t_valid or x.shape[1])) if center else 0.0
    m, n = x.shape[0], w.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    yc = torch.empty((m, n), dtype=out_dtype, device=x.device)
    rs, ss = torch.empty(m, **f32), torch.empty(m, **f32)
    for sl in _row_slices(x):
        xc = x[sl].float()
        rs[sl] = xc.sum(dim=1)
        ss[sl] = xc.square().sum(dim=1)
        yc[sl] = (xc @ wf).sub_((rs[sl] * inv_t)[:, None] * colw[None, :]).to(out_dtype)
    g = torch.zeros((n, n), **f32)
    for sl in _row_slices(yc):
        ycf = yc[sl].float()
        g.addmm_(ycf.T, ycf)
    return yc, rs, ss, g


def _k2_plan(x, w, out_dtype, center, t_valid):
    """K2's outputs on its route (``ops/k2.py::k2_block``'s table: the
    cluster kernels or K1's sketch and G stages), allocated, ``run(mask)``
    (1 the sketch, 2 G), which launches them into the outputs, and the
    route's block."""
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major M x T)")
    (m, t_cols), n = x.shape, w.shape[1]
    block = k2.k2_block(m, t_cols, n, x.dtype, out_dtype, base_aligned=x.data_ptr() % 16 == 0)
    if block.route == "stages":
        out, run = _scgp_plan(x, w, out_dtype, center, False, False, t_valid, True, _K2_STAGES)
        return out, run, block
    w, colw, inv_t = _prepare(w, t_cols, center, False, t_valid)
    out, run = k2.plan(x, w, colw, inv_t, block)
    return out, run, block


def _sketch_center_gram_cuda(x, w, out_dtype, center, t_valid):
    out, run, block = _k2_plan(x, w, out_dtype, center, t_valid)
    run(_K2_STAGES)
    sketch_center_gram.launches += 1
    sketch_center_gram.launches_by_route[block.route] += 1
    return out["yc"], out["stats"][:, 0], out["stats"][:, 1], out["g"]


def sketch_center_gram(
    x: torch.Tensor,
    w: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
    center: bool = True,
    t_valid: int | None = None,
):
    """(Yc, rowsum, rowsumsq, G) from one read of X: the first pass of
    the fallback (``dmd_era5_tpu/ops/matmul.py:491``, kernels K2a/K2b).

    x: (M, T); w: (T, N), both float32 or both bfloat16.  Returns Yc
    (M, N) ``out_dtype`` = X W - (rowsum / T) colsum(W) (no correction
    with ``center=False``), rowsum and rowsumsq (M,) f32 from the f32
    values of X, and G = Yc^T Yc (N, N) f32 from the STORED Yc.
    ``t_valid`` replaces T as the centring divisor (trailing zero
    columns), which the JAX entry does not take.  Any M and T; N up to
    ``SKETCH_N_MAX``.

    A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
    the route of ``ops/k2.py::k2_block``'s table: bf16 X, W and Yc at N
    257-512 on the cluster kernels of ``csrc/sketch_center_gram.cu``, the
    rest on K1's sketch and G stages (``csrc/sketch_center_gram_project.cu``
    with the statistics from X, and ``csrc/atb.cu``).  It counts one launch
    a call in ``sketch_center_gram.launches``, apart from K1's count, and
    in ``sketch_center_gram.launches_by_route`` under the route's name.
    """
    _check_sketch(x, w, out_dtype, t_valid)
    if x.device.type == "cpu":
        return _sketch_center_gram_plain(x, w, out_dtype, center, t_valid)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _sketch_center_gram_cuda(x, w, out_dtype, center, t_valid)


sketch_center_gram.launches = 0
# the same launches split by route, for the smoke's kernels line: ``launches``
# stays the one count a call that every wrapper keeps and ``launch_counts``
# and the tests read, so both are added to in one place
sketch_center_gram.launches_by_route = {"clusters": 0, "stages": 0}


def _check_project(x, y):
    if x.ndim != 2 or y.ndim != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(f"need x (M, T) and y (M, N); got {tuple(x.shape)}, {tuple(y.shape)}")
    if x.dtype not in _DTYPES or y.dtype not in _DTYPES:
        raise ValueError(f"x and y must each be one of {_DTYPES}; got {x.dtype}, {y.dtype}")
    if y.device != x.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if min(*x.shape, y.shape[1]) < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, y {tuple(y.shape)}")


def _project_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: f32 products (TF32 off on a card),
    summed row chunk by row chunk in f32."""
    _check_project(x, y)
    c = None
    for sl in _row_slices(x):
        part = y[sl].float().T @ x[sl].float()
        c = part if c is None else c.add_(part)
    return c


# K3's blocks (csrc/project.cu's table), which K1's C stage takes too: 128
# columns of the m side's operand (two m64 warpgroups) by n columns of the
# other, n a multiple of 8 up to _PROJECT_N_MAX; the f64 sums in registers
# up to _PROJECT_REG_N, past it in shared memory (_PROJECT_SMEM_WIDTHS).
# f32 x f32 with a side of C wider than _PROJECT_ROW_SHARE_WIDE stays on
# the row-share mainloop, 128 x 128 blocks, where project_wgmma was
# measured slower: the hourly year's 8,760 (csrc/project_wgmma.cuh's tile
# table) and the bench's 128 x 512 C stage (1.074 ms against 1.241 on an
# H100 80GB HBM3 at 700 W, scripts/torch_k4_times.py --c-blocks); at the
# week's 256 x 168 project_wgmma reads faster (21.99 against 31.08).
_PROJECT_BM = 128
_PROJECT_N_MAX = 88
_PROJECT_REG_N = 64
_PROJECT_SMEM_WIDTHS = (72, 80, 88)
_PROJECT_ROW_SHARE_WIDE = 384


class ProjectBlock(NamedTuple):
    """K3's block of C for one call: ``transposed`` puts X on the MMA's m
    side (the kernel computes blocks of C^T), ``m`` and ``n`` are the
    block's edges on the m and n sides, ``m_blocks`` and ``n_blocks`` how
    many of them cover C, ``sums`` where their f64 sums live, ``mainloop``
    the kernel: ``project_wgmma`` or ``row_share`` (Y on m, 128 x 128)."""

    transposed: bool
    m: int
    n: int
    m_blocks: int
    n_blocks: int
    sums: str  # "registers" or "shared"
    mainloop: str = "project_wgmma"


def project_block(m: int, n: int, t: int, y_dtype: torch.dtype, x_dtype: torch.dtype
                  ) -> ProjectBlock:
    """K3's (and K1's C stage's) block for C = Y^T X with X (m, t) and Y
    (m, n): one operand on the MMA's m side in blocks of 128 columns, the
    other on its n side, rounded up to 8 or cut into the fewest equal
    pieces of at most ``_PROJECT_N_MAX``; of the two orientations the one
    with the fewest MMA entries (padding included), C's narrow side on n
    on a tie; the f64 sums in registers up to ``_PROJECT_REG_N``, past it
    in shared memory.  An f32 x bf16 pair puts its f32 operand on the m
    side whatever the shape (the kernel's one mixed instantiation).  f32 x
    f32 with a side past ``_PROJECT_ROW_SHARE_WIDE`` takes the row-share
    mainloop.  The fewest entries put Y on m at K1's 128 x 168 C (the fit
    step, 17b: one 128-row block, 12.24 ms against 18.02 with X on m at the
    week's f32 fit step, scripts/torch_k4_times.py --c-blocks); at every
    K3 shape of the main path they agree with the narrow side on n."""
    y_bf16, x_bf16 = y_dtype == torch.bfloat16, x_dtype == torch.bfloat16
    if not (y_bf16 or x_bf16) and max(n, t) > _PROJECT_ROW_SHARE_WIDE:
        return ProjectBlock(False, _PROJECT_BM, 128, -(-n // _PROJECT_BM), -(-t // 128), "shared",
                            "row_share")

    def oriented(transposed: bool) -> tuple[int, ProjectBlock]:
        wide, narrow = (t, n) if transposed else (n, t)
        pieces = -(-narrow // _PROJECT_N_MAX)
        bn = 8 * -(-(-(-narrow // pieces)) // 8)
        m_blocks, n_blocks = -(-wide // _PROJECT_BM), -(-narrow // bn)
        return m_blocks * _PROJECT_BM * n_blocks * bn, ProjectBlock(
            transposed, _PROJECT_BM, bn, m_blocks, n_blocks,
            "registers" if bn <= _PROJECT_REG_N else "shared")

    if y_bf16 != x_bf16:
        return oriented(y_bf16)[1]
    (area_0, block_0), (area_1, block_1) = oriented(n < t), oriented(n >= t)
    return block_1 if area_1 < area_0 else block_0


_PROJECT_LIB = None


def _project_library():
    global _PROJECT_LIB
    if _PROJECT_LIB is None:
        from dmd_era5_tpu_torch.ops._build import load_kernel_library

        lib = load_kernel_library("project")
        ptr, flag = ctypes.c_void_p, ctypes.c_int
        # y, x, per-share f64 partials, C, m, n, t, y_bf16, x_bf16, transposed,
        # block n, sums in shared memory, n_share, stream
        lib.project_launch.argtypes = [
            ptr, ptr, ptr, ptr, ctypes.c_longlong, flag, flag, flag, flag, flag, flag, flag, flag,
            ptr,
        ]
        lib.project_launch.restype = ctypes.c_int
        # y_bf16, x_bf16, transposed, block n, sums in shared memory, &out
        lib.project_ctas_per_sm.argtypes = [flag, flag, flag, flag, flag, ptr]
        lib.project_ctas_per_sm.restype = ctypes.c_int
        _PROJECT_LIB = lib
    return _PROJECT_LIB


def _project_args(x: torch.Tensor, y: torch.Tensor, block: ProjectBlock) -> tuple:
    """The operand and block flags of project_launch and project_ctas_per_sm
    (block n 0: the row-share mainloop)."""
    return (int(y.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16), int(block.transposed),
            block.n if block.mainloop == "project_wgmma" else 0, int(block.sums == "shared"))


def _project_wave(dev, flags: tuple) -> int:
    """CTAs of K3's kernel for these flags that run at once on the card."""
    return resident_ctas(dev, ("project", *flags),
                         lambda out: _project_library().project_ctas_per_sm(*flags, out))


def _project_row_shares(x: torch.Tensor, y: torch.Tensor, block: ProjectBlock | None = None) -> int:
    """Row shares K3 takes for C = Y^T X on the card: whole waves of its
    CTAs over the blocks of C (``block``, by default
    :func:`project_block`'s), its f64 scratch (n_share N T doubles) held
    within 1 GiB."""
    (m, t_cols), n = x.shape, y.shape[1]
    block = block or project_block(m, n, t_cols, y.dtype, x.dtype)
    wave = _project_wave(x.device, _project_args(x, y, block))
    return wave_row_shares(wave, block.m_blocks * block.n_blocks, m, 8 * n * t_cols)


def _project_launch(x: torch.Tensor, y: torch.Tensor, block: ProjectBlock | None = None
                    ) -> torch.Tensor:
    """C = Y^T X on K3's kernel in ``block`` (by default
    :func:`project_block`'s), uncounted: :func:`project` counts its own
    launches, K1's C stage at the hourly year takes this route too."""
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous (row-major)")
    (m, t_cols), n, dev = x.shape, y.shape[1], x.device
    block = block or project_block(m, n, t_cols, y.dtype, x.dtype)
    n_share = _project_row_shares(x, y, block)
    logger.debug("project: %s, %d row shares, %.1f MB of f64 scratch", block, n_share,
                 8 * n_share * n * t_cols / 1e6)
    with torch.cuda.device(dev):
        c = torch.empty((n, t_cols), dtype=torch.float32, device=dev)
        part = torch.empty((n_share, n, t_cols), dtype=torch.float64, device=dev)
        rc = _project_library().project_launch(
            y.data_ptr(), x.data_ptr(), part.data_ptr(), c.data_ptr(), m, n, t_cols,
            *_project_args(x, y, block), n_share, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"project kernel: CUDA error {rc}")
    return c


def _project_cuda(x: torch.Tensor, y: torch.Tensor, block: ProjectBlock | None = None
                  ) -> torch.Tensor:
    c = _project_launch(x, y, block)
    project.launches += 1
    return c


def project(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C = Y^T X (N, T) f32 in one streaming pass over X and Y: the
    second pass of the fallback (``dmd_era5_tpu/ops/matmul.py:610``,
    kernel K3).

    x: (M, T); y: (M, N), each float32 or bfloat16.  Any M, T and N.  A
    CPU tensor takes the plain PyTorch version; a CUDA tensor launches
    the Hopper kernel (``csrc/project.cu`` on ``csrc/project_wgmma.cuh``,
    its block from :func:`project_block`) and counts it in
    ``project.launches``.
    """
    _check_project(x, y)
    if x.device.type == "cpu":
        return _project_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _project_cuda(x, y)


project.launches = 0


# ------------------------------------------------------------ tiled matmul


# K6's and K1's sketch blocks (csrc/matmul_tc.cuh's tile table): out's
# columns a CTA, the narrowest wgmma width of the kernel's table that holds
# N, wider N in CTA columns of 112 (K6) or 128 (the sketch); x's copy path
# (TMA where its rows and base are 16-byte aligned, BULK for f32 rows that
# are not, a tile a slot, at the narrow widths, ELEM for the rest at 112 or
# 128 columns); w's rows held, all of K where it fits beside two ring slots
# (BULK: K padded to 32), else panels; and as many ring slots as the shared
# memory left holds, up to _MM_RING.  K1's f32 sketch streams W past
# _MM_STREAM_T rows of K (its split chunks ride the ring, 4 slots, 128
# columns).
_MM_WIDTHS = (24, 40, 80, 112, 128)
_MM_BULK_WIDTHS = (24, 40, 80)
_MM_LOADS = ("tma", "bulk", "elem")  # the kernel's numbers for them (mm_tc::Load)
_MM_SMEM_CAP = 232_448  # shared memory of one CTA
_MM_MAX_STAGES = 8  # ring slots the kernel takes (its barriers' room)
_MM_RING = 4  # ring slots the rule gives, at most: 8 read within 3% at 15c, the lift chunk and
#               K1's bf16 sketch, 5% slower at the bf16 week block (torch_k6_phases.py's ring_8)
_MM_STREAM_T = 176


class MatmulBlock(NamedTuple):
    """K6's (or, with ``center``, K1's sketch stage's) block for one call:
    ``n`` columns of out a CTA in ``columns`` CTA columns, x's copy path
    ``load``, ``panel`` rows of K of w held (all of K, padded, where it
    fits), ``stages`` ring slots, ``stream``: W's split chunks ride the ring
    (K1's f32 sketch past ``_MM_STREAM_T``), ``smem`` the CTA's bytes of
    shared memory."""

    n: int
    columns: int
    load: str  # "tma", "bulk" or "elem"
    panel: int
    stages: int
    stream: bool
    smem: int


def _mm_smem(load: str, itemsize: int, k: int, bn: int, kw: int, stages: int,
             stream: bool = False) -> int:
    """Shared memory of a CTA (csrc/matmul_tc.cuh::smem_bytes): the ring
    (16 KB chunk slots, or BULK's tile of 128 rows of K f32, rounded to 128
    bytes), w (kw rows of K x bn, 8 bytes an entry in f32, 2 in bf16; or a
    32-row chunk a slot where W streams), 64 bytes of barriers, the staged
    rows of out (all 128 of a tile where bn <= 80, else 32) and 512 bytes of
    row means."""
    slot = -(-128 * k * 4 // 128) * 128 if load == "bulk" else 16_384
    w_area = stages * 32 * 8 * bn if stream else kw * (8 if itemsize == 4 else 2) * bn
    staged = (128 if bn <= 80 else 32) * bn * 4
    return 1024 + stages * slot + w_area + 8 * _MM_MAX_STAGES + staged + 512


def _mm_w_stream_bytes(k: int, n: int) -> int:
    """Bytes of W's split chunks where the sketch streams W: per CTA column
    of 128 and chunk of 32 rows of K, a tf32 hi and a lo plane."""
    return -(-n // 128) * -(-k // 32) * 32 * 8 * 128


def matmul_block(m: int, k: int, n: int, dtype: torch.dtype, center: bool = False,
                 base_aligned: bool = True, width: int | None = None,
                 stream: bool | None = None, load: str | None = None) -> MatmulBlock:
    """The block of K6 (``center`` False) or of K1's sketch stage for
    x (m, k) @ w (k, n) of ``dtype`` (float32 or bfloat16); ``base_aligned``:
    x's first element is 16-byte aligned.  The rule is the tile table of
    ``csrc/matmul_tc.cuh``; the kernel's launch checks what it is given.
    ``width``, ``stream`` and ``load`` replace the rule's columns a CTA,
    its choice to stream W and its copy path (``scripts/torch_tc_tables.py``
    and ``scripts/torch_k6_phases.py`` time the table's choices against
    each other)."""
    f32 = dtype == torch.float32
    itemsize = 4 if f32 else 2
    kstep, panel = (8, 160) if f32 else (16, 640)
    tma = base_aligned and k * itemsize % 16 == 0
    if stream is None:
        stream = center and f32 and tma and k > _MM_STREAM_T
    if stream:
        if not (center and f32 and tma):
            raise ValueError("W streams for K1's f32 sketch on x whose rows allow TMA only")
        return MatmulBlock(128, -(-n // 128), "tma", 32, 4, True,
                           _mm_smem("tma", 4, k, 128, 32, 4, stream=True))
    bn = width or next((w for w in _MM_WIDTHS if n <= w), 128 if center else 112)
    kw = -(-k // 32) * 32  # BULK's: whole 32-column groups
    bulk = (f32 and base_aligned and bn in _MM_BULK_WIDTHS
            and _mm_smem("bulk", 4, k, bn, kw, 2) <= _MM_SMEM_CAP)
    if load is None:
        load = "tma" if tma else "bulk" if bulk else "elem"
    elif not {"tma": tma, "bulk": bulk, "elem": True}[load]:
        raise ValueError(f"no {load} copy path for x ({m}, {k}) {dtype} at {bn} columns")
    if load == "elem" and width is None:  # the element-wise path's widths
        bn = 112 if n <= 112 or (n > 128 and not center) else 128
    if load != "bulk":
        kw = -(-k // kstep) * kstep
        if _mm_smem(load, itemsize, k, bn, kw, 2) > _MM_SMEM_CAP:
            kw = panel
    slot = _mm_smem(load, itemsize, k, bn, kw, 1) - _mm_smem(load, itemsize, k, bn, kw, 0)
    stages = 2 if load == "elem" else min(
        _MM_RING, (_MM_SMEM_CAP - _mm_smem(load, itemsize, k, bn, kw, 0)) // slot)
    return MatmulBlock(bn, -(-n // bn), load, kw, stages, False,
                       _mm_smem(load, itemsize, k, bn, kw, stages))


def _matmul_plain(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the kernel: bf16 operands are upcast
    BEFORE the product (a bf16 ``torch.mm`` would return bf16), so both
    dtypes are f32 products summed in f32 (TF32 off on a card)."""
    return (x.float() @ w.float()).to(out_dtype)


_MM_LIB = None


def _matmul_library():
    global _MM_LIB
    if _MM_LIB is None:
        from dmd_era5_tpu_torch.ops._build import load_kernel_library

        lib = load_kernel_library("matmul")
        ptr, flag = ctypes.c_void_p, ctypes.c_int
        # x, w, out, m, k, n, x_bf16, out_bf16, the block (width, copy path,
        # rows of w held, ring slots), ctas, stream
        lib.matmul_launch.argtypes = [
            ptr, ptr, ptr, ctypes.c_longlong, flag, flag, flag, flag, flag, flag, flag, flag,
            flag, ptr,
        ]
        lib.matmul_launch.restype = ctypes.c_int
        # x_bf16, width, copy path, shared memory, &out
        lib.matmul_ctas_per_sm.argtypes = [flag, flag, flag, flag, ptr]
        lib.matmul_ctas_per_sm.restype = ctypes.c_int
        _MM_LIB = lib
    return _MM_LIB


def _matmul_cuda(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype,
                 block: MatmulBlock | None = None) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major M x K)")
    w = w.contiguous()  # (K, N): small
    (m, k), n = x.shape, w.shape[1]
    dev, x_bf16 = x.device, int(x.dtype == torch.bfloat16)
    block = block or matmul_block(m, k, n, x.dtype, base_aligned=x.data_ptr() % 16 == 0)
    load = _MM_LOADS.index(block.load)
    lib = _matmul_library()
    with torch.cuda.device(dev):
        # persistent CTAs, as many as run at once on the card
        ctas = resident_ctas(dev, ("matmul", x_bf16, block),
                             lambda res: lib.matmul_ctas_per_sm(x_bf16, block.n, load, block.smem,
                                                                res))
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
        rc = lib.matmul_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, x_bf16,
            int(out_dtype == torch.bfloat16), block.n, load, block.panel, block.stages, ctas,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"matmul kernel: CUDA error {rc}")
    matmul.launches += 1
    return out


def matmul(
    x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) ``out_dtype``, summed in f32.

    Counterpart of ``dmd_era5_tpu/ops/matmul.py:101`` (kernel K6).  x and
    w share one dtype: float32 (f32-faithful products, the JAX package's
    ``HIGHEST``; 3xTF32 on the card's tensor cores) or bfloat16 (products
    exact in f32, its ``DEFAULT`` bf16 pass).  Any M, K and N: the JAX
    entry's divisibility by its blocks is a TPU tiling constraint, and the
    kernel masks ragged edges.

    A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
    the Hopper kernel (``csrc/matmul.cu`` on ``csrc/matmul_tc.cuh``, its
    block from :func:`matmul_block`) and counts it in ``matmul.launches``.
    """
    _check_operands(x, w, out_dtype)
    if x.device.type == "cpu":
        return _matmul_plain(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _matmul_cuda(x, w, out_dtype)


matmul.launches = 0
