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

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/sketch_center_gram_project.cu`` K1, and K2 as K1's sketch and G
stages, ``csrc/project.cu`` K3, ``csrc/matmul.cu`` K6); on a CPU tensor it
takes the plain PyTorch version beside it, which does the same
arithmetic with ``torch.matmul``.  There is no fallback between the two:
which pass runs is decided by the shapes alone, the same on both.
"""

from __future__ import annotations

import ctypes
import logging

import torch

from dmd_era5_tpu_torch.ops._occupancy import resident_ctas, wave_row_shares

__all__ = [
    "sketch_center_gram_project",
    "sketch_center_gram",
    "project",
    "takes_two_pass",
    "matmul",
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
_STAGES = 7  # K1's sketch, G and C stages (bits 0-2 of scgp_launch's mask)
_K2_STAGES = 3  # K2: the sketch and G stages of the same library


def _kernel_library():
    global _LIB
    if _LIB is None:
        from dmd_era5_tpu_torch.ops._build import load_kernel_library

        lib = load_kernel_library("sketch_center_gram_project")
        ptr, flag = ctypes.c_void_p, ctypes.c_int
        lib.scgp_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,  # x, w, W's split chunks, colw, yc, stats
            ptr, ptr,  # scalar stats: per-CTA f64 sums, reduced
            ptr, ptr, ptr, ptr,  # G: per-share f64 scratch, reduced; C: the same
            ctypes.c_longlong, flag, flag,  # m, t, n
            flag, flag, flag, ctypes.c_float,  # x_bf16, out_bf16, stats_col, inv_t
            flag, flag, flag,  # the sketch's CTAs, G and C row shares
            flag, ptr,  # stages, stream
        ]
        lib.scgp_launch.restype = ctypes.c_int
        # stage, x_bf16, out_bf16, t, n, &out
        lib.scgp_ctas_per_sm.argtypes = [flag, flag, flag, flag, flag, ptr]
        lib.scgp_ctas_per_sm.restype = ctypes.c_int
        lib.scgp_gram_blocks.argtypes = [flag, flag]  # out_bf16, n
        lib.scgp_gram_blocks.restype = ctypes.c_int
        lib.scgp_w_stream_bytes.argtypes = [flag, flag, flag]  # x_bf16, t, n
        lib.scgp_w_stream_bytes.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def _stage_wave(dev, stage: int, x_bf16: int, out_bf16: int, t_cols: int, n: int) -> int:
    """CTAs of one of K1's stages (0 sketch, 1 G, 2 C) resident on the card
    at once: the sketch's depend on its columns a CTA (by n) and how much of
    W its CTAs hold (by T), G's on its block edge (by n)."""
    t_key = t_cols if stage == 0 else 1
    n_key = n if stage < 2 else 1
    return resident_ctas(
        dev, ("sketch_center_gram_project", stage, x_bf16, out_bf16, t_key, n_key),
        lambda out: _kernel_library().scgp_ctas_per_sm(stage, x_bf16, out_bf16, t_key, n_key, out),
    )


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _scgp_plan(x, w, out_dtype, center, stats_col, scalar_stats, t_valid, emit_yc,
               stages=_STAGES):
    """The outputs of the stages in ``stages`` (1 sketch, 2 G = Yc^T Yc,
    4 C = Yc^T X: 7 for K1, 3 for K2), allocated, and ``run(mask)``, which
    launches the stages in the mask into them.  Yc is allocated as scratch
    where ``emit_yc`` is off: G and C are read from it.  The sketch runs on
    the card's resident CTAs; G and C on the row shares that fill whole
    waves over their blocks (G's upper ones, ``scgp_gram_blocks``; C's
    128 x 128), their f64 scratch within 1 GiB.  The library picks the
    sketch's columns a CTA, whether it streams W (W's split chunks then take
    ``scgp_w_stream_bytes`` of scratch) and G's block edge from its own
    tables."""
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major M x T)")
    w, colw, inv_t = _prepare(w, x.shape[1], center, stats_col, t_valid)
    (m, t_cols), n, dev = x.shape, w.shape[1], x.device
    x_bf16, out_bf16 = int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16)
    lib = _kernel_library()
    nb, nt = -(-n // 128), -(-t_cols // 128)  # blocks of C
    with torch.cuda.device(dev):
        waves = [_stage_wave(dev, st, x_bf16, out_bf16, t_cols, n) if stages >> st & 1 else 0
                 for st in range(3)]
    g_shares = wave_row_shares(waves[1], lib.scgp_gram_blocks(out_bf16, n), m, 8 * n * n)
    c_shares = wave_row_shares(waves[2], nb * nt, m, 8 * n * t_cols) if stages & 4 else 0
    f32, f64 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.float64, device=dev)
    out = dict(
        yc=torch.empty((m, n), dtype=out_dtype, device=dev),
        stats=None if scalar_stats else torch.empty((m, 2), **f32),
        st=torch.empty(2, **f32) if scalar_stats else None,
        g=torch.empty((n, n), **f32),
        c=torch.empty((n, t_cols), **f32) if stages & 4 else None,
    )
    st_part = torch.empty((waves[0], 2), **f64) if scalar_stats else None
    # where the sketch streams W (long f32 time axes), W split into tf32 chunks
    w_bytes = lib.scgp_w_stream_bytes(x_bf16, t_cols, n)
    w_split = torch.empty(w_bytes, dtype=torch.uint8, device=dev) if w_bytes else None
    g_part = torch.empty((g_shares, n, n), **f64)
    c_part = torch.empty((c_shares, n, t_cols), **f64) if stages & 4 else None
    logger.debug("sketch_center_gram_project: %d sketch CTAs, %d / %d row shares of G / C",
                 waves[0], g_shares, c_shares)

    def run(stages: int) -> None:
        with torch.cuda.device(dev):
            rc = _kernel_library().scgp_launch(
                _ptr(x), _ptr(w), _ptr(w_split), _ptr(colw), _ptr(out["yc"]), _ptr(out["stats"]),
                _ptr(st_part), _ptr(out["st"]), _ptr(g_part), _ptr(out["g"]), _ptr(c_part),
                _ptr(out["c"]), m, t_cols, n, x_bf16, out_bf16, int(stats_col), inv_t,
                waves[0], g_shares, c_shares, stages,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"sketch_center_gram_project kernel: CUDA error {rc}")

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


def _sketch_center_gram_cuda(x, w, out_dtype, center, t_valid):
    out, run = _scgp_plan(x, w, out_dtype, center, False, False, t_valid, True, _K2_STAGES)
    run(_K2_STAGES)
    sketch_center_gram.launches += 1
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
    K1's sketch and G stages (``csrc/sketch_center_gram_project.cu``:
    with the statistics from X, no C) and counts them in
    ``sketch_center_gram.launches``, apart from K1's count.
    """
    _check_sketch(x, w, out_dtype, t_valid)
    if x.device.type == "cpu":
        return _sketch_center_gram_plain(x, w, out_dtype, center, t_valid)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _sketch_center_gram_cuda(x, w, out_dtype, center, t_valid)


sketch_center_gram.launches = 0


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


_PROJECT_LIB = None


def _project_library():
    global _PROJECT_LIB
    if _PROJECT_LIB is None:
        from dmd_era5_tpu_torch.ops._build import load_kernel_library

        lib = load_kernel_library("project")
        ptr, flag = ctypes.c_void_p, ctypes.c_int
        # y, x, per-share f64 partials, C, m, n, t, y_bf16, x_bf16, n_share, stream
        lib.project_launch.argtypes = [
            ptr, ptr, ptr, ptr, ctypes.c_longlong, flag, flag, flag, flag, flag, ptr,
        ]
        lib.project_launch.restype = ctypes.c_int
        lib.project_ctas_per_sm.argtypes = [flag, flag, ptr]  # y_bf16, x_bf16, &out
        lib.project_ctas_per_sm.restype = ctypes.c_int
        lib.project_block_edge.argtypes = []
        lib.project_block_edge.restype = ctypes.c_int
        _PROJECT_LIB = lib
    return _PROJECT_LIB


def _project_row_shares(x: torch.Tensor, y: torch.Tensor) -> int:
    """Row shares K3 takes for C = Y^T X on the card: whole waves of its
    CTAs over the blocks of C, its f64 scratch (n_share N T doubles) held
    within 1 GiB."""
    (m, t_cols), n, dev = x.shape, y.shape[1], x.device
    y_bf16, x_bf16 = int(y.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16)
    lib = _project_library()
    with torch.cuda.device(dev):
        wave = resident_ctas(dev, ("project", y_bf16, x_bf16),
                              lambda out: lib.project_ctas_per_sm(y_bf16, x_bf16, out))
    edge = lib.project_block_edge()
    return wave_row_shares(wave, -(-n // edge) * -(-t_cols // edge), m, 8 * n * t_cols)


def _project_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous (row-major)")
    (m, t_cols), n, dev = x.shape, y.shape[1], x.device
    n_share = _project_row_shares(x, y)
    logger.debug("project: %d row shares, %.1f MB of f64 scratch", n_share,
                 8 * n_share * n * t_cols / 1e6)
    with torch.cuda.device(dev):
        c = torch.empty((n, t_cols), dtype=torch.float32, device=dev)
        part = torch.empty((n_share, n, t_cols), dtype=torch.float64, device=dev)
        rc = _project_library().project_launch(
            y.data_ptr(), x.data_ptr(), part.data_ptr(), c.data_ptr(), m, n, t_cols,
            int(y.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16), n_share,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"project kernel: CUDA error {rc}")
    project.launches += 1
    return c


def project(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C = Y^T X (N, T) f32 in one streaming pass over X and Y: the
    second pass of the fallback (``dmd_era5_tpu/ops/matmul.py:610``,
    kernel K3).

    x: (M, T); y: (M, N), each float32 or bfloat16.  Any M, T and N.  A
    CPU tensor takes the plain PyTorch version; a CUDA tensor launches
    the Hopper kernel (``csrc/project.cu``) and counts it in
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
        # x, w, out, m, k, n, x_bf16, out_bf16, ctas, stream
        lib.matmul_launch.argtypes = [
            ptr, ptr, ptr, ctypes.c_longlong, flag, flag, flag, flag, flag, ptr,
        ]
        lib.matmul_launch.restype = ctypes.c_int
        lib.matmul_ctas_per_sm.argtypes = [flag, flag, ptr]
        lib.matmul_ctas_per_sm.restype = ctypes.c_int
        _MM_LIB = lib
    return _MM_LIB


def _matmul_cuda(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major M x K)")
    w = w.contiguous()  # (K, N): small
    (m, k), n = x.shape, w.shape[1]
    dev, x_bf16 = x.device, int(x.dtype == torch.bfloat16)
    lib = _matmul_library()
    with torch.cuda.device(dev):
        # persistent CTAs, as many as run at once on the card
        ctas = resident_ctas(dev, ("matmul", x_bf16, k),
                             lambda res: lib.matmul_ctas_per_sm(x_bf16, k, res))
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
        rc = lib.matmul_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, x_bf16,
            int(out_dtype == torch.bfloat16), ctas, torch.cuda.current_stream(dev).cuda_stream,
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
    the Hopper kernel and counts it in ``matmul.launches``.
    """
    _check_operands(x, w, out_dtype)
    if x.device.type == "cpu":
        return _matmul_plain(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _matmul_cuda(x, w, out_dtype)


matmul.launches = 0
