"""The fused sketch / centre / Gram / projection pass over X, and the
tiled matmul of the streamed sketch.

PyTorch counterpart of ``dmd_era5_tpu/ops/matmul.py::
sketch_center_gram_project``.  From ONE read of the snapshot matrix
X (M, T) and a sketch W (T, N) it returns

    Yc = X W - (rowsum / t_valid) colsum(W)      stored in ``out_dtype``
    rowsum, rowsumsq                             (or their two scalar sums)
    G  = Yc^T Yc,   C = Yc^T X                   both from the STORED Yc

and of ``dmd_era5_tpu/ops/matmul.py::matmul``: (M, K) @ (K, N) summed
in f32, the per-block sketch of the out-of-core SVD.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/sketch_center_gram_project.cu``, ``csrc/matmul.cu``); on a CPU
tensor it takes the plain PyTorch version beside it, which does the
same arithmetic with ``torch.matmul``.  There is no fallback between
the two.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["sketch_center_gram_project", "matmul", "N_MAX"]

# Widest sketch of the Hopper kernel.  Wider ones need the two-pass
# fallback of the JAX package (kernels K2 sketch_center_gram and K3
# project), which is not ported yet.  The kernel takes any T: its cost
# in T is the f64 scratch of per-CTA partials, n_cta * N * (N + T) * 8
# bytes, allocated below.
N_MAX = 256
_DTYPES = (torch.float32, torch.bfloat16)


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
    t_cols, n = w.shape
    if n > N_MAX:
        raise ValueError(
            f"sketch width {n} is outside the fused kernel's range (max "
            f"{N_MAX}); the two-pass fallback (K2 sketch_center_gram + K3 "
            "project) is not ported yet"
        )
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
    rows its f32 sums are less accurate than the kernel's, whose per-CTA
    partials accumulate in f64.
    """
    _check(x, w, out_dtype, t_valid)
    w, colw, inv_t = _prepare(w, x.shape[1], center, stats_col, t_valid)
    xf = x.float()
    y = xf @ w.float()
    if stats_col:
        # the ones column gives the pre-centering row sum; the square
        # is taken in the storage dtype, summed in f32
        rs = y[:, -1].clone()
        ssq = (x * x).float().sum(dim=1)
    else:
        rs = xf.sum(dim=1)
        ssq = (xf * xf).sum(dim=1)
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


def _kernel_library():
    global _LIB
    if _LIB is None:
        from dmd_era5_tpu_torch.ops._build import load_kernel_library

        lib = load_kernel_library("sketch_center_gram_project")
        ptr = ctypes.c_void_p
        flag = ctypes.c_int
        lib.scgp_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr,  # x, w, colw, yc, stats
            ptr, ptr, ptr,  # per-CTA f64 partials: G, C, scalar stats
            ptr, ptr, ptr,  # reduced G, C, scalar stats
            ctypes.c_longlong, flag, flag,  # m, t, n
            flag, flag, flag, flag, flag,  # x_bf16, out_bf16, stats_col, scalar_stats, emit_yc
            ctypes.c_float, flag, ptr,  # inv_t, n_cta, stream
        ]
        lib.scgp_launch.restype = ctypes.c_int
        lib.scgp_ctas_per_sm.argtypes = [flag, flag, flag, ptr]  # x_bf16, out_bf16, n, &out
        lib.scgp_ctas_per_sm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


_CTAS_PER_SM: dict[tuple, int] = {}


def _grid(dev, x_bf16: int, out_bf16: int, n: int) -> int:
    """CTAs that run at once on the card: SMs x resident CTAs per SM.

    One wave covers the card; each CTA then walks its row tiles, and
    the f64 partial scratch holds one copy per CTA.
    """
    key = (dev.index, x_bf16, out_bf16, n)
    if key not in _CTAS_PER_SM:
        per_sm = ctypes.c_int(0)
        rc = _kernel_library().scgp_ctas_per_sm(
            x_bf16, out_bf16, n, ctypes.addressof(per_sm)
        )
        if rc != 0 or per_sm.value < 1:
            raise RuntimeError(
                f"sketch_center_gram_project occupancy: CUDA error {rc}, "
                f"{per_sm.value} CTAs per SM"
            )
        _CTAS_PER_SM[key] = per_sm.value
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * _CTAS_PER_SM[key]


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _sketch_center_gram_project_cuda(
    x, w, out_dtype, center, stats_col, scalar_stats, t_valid, emit_yc
):
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major M x T)")
    w, colw, inv_t = _prepare(w, x.shape[1], center, stats_col, t_valid)
    m, t_cols = x.shape
    n = w.shape[1]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    x_bf16, out_bf16 = int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16)
    n_tiles = -(-m // 128)  # rows per tile in the kernel (MT)
    with torch.cuda.device(dev):
        n_cta = min(n_tiles, _grid(dev, x_bf16, out_bf16, n))
    yc = torch.empty((m, n), dtype=out_dtype, device=dev) if emit_yc else None
    stats = None if scalar_stats else torch.empty((m, 2), **f32)
    st = torch.empty(2, **f32) if scalar_stats else None
    g = torch.empty((n, n), **f32)
    c = torch.empty((n, t_cols), **f32)
    f64 = dict(dtype=torch.float64, device=dev)  # per-CTA partials
    g_part = torch.empty((n_cta, n, n), **f64)
    c_part = torch.empty((n_cta, n, t_cols), **f64)
    st_part = torch.empty((n_cta, 2), **f64) if scalar_stats else None
    lib = _kernel_library()
    with torch.cuda.device(dev):
        rc = lib.scgp_launch(
            _ptr(x), _ptr(w), _ptr(colw), _ptr(yc), _ptr(stats),
            _ptr(g_part), _ptr(c_part), _ptr(st_part),
            _ptr(g), _ptr(c), _ptr(st),
            m, t_cols, n, x_bf16, out_bf16,
            int(stats_col), int(scalar_stats), int(emit_yc),
            inv_t, n_cta, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sketch_center_gram_project kernel: CUDA error {rc}")
    # the scratch and w/colw copies are released on return while the
    # kernels may still run: the caching allocator hands their memory
    # only to later work on this same stream, which runs after them
    sketch_center_gram_project.launches += 1
    if scalar_stats:
        return yc, st[0], st[1], g, c
    return yc, stats[:, 0], stats[:, 1], g, c


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

    A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
    the Hopper kernel and counts the launch in
    ``sketch_center_gram_project.launches``.
    """
    _check(x, w, out_dtype, t_valid)
    args = (out_dtype, center, stats_col, scalar_stats, t_valid, emit_yc)
    if x.device.type == "cpu":
        return _sketch_center_gram_project_plain(x, w, *args)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _sketch_center_gram_project_cuda(x, w, *args)


sketch_center_gram_project.launches = 0


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
        # x, w, out, m, k, n, x_bf16, out_bf16, stream
        lib.matmul_launch.argtypes = [
            ptr, ptr, ptr, ctypes.c_longlong, flag, flag, flag, flag, ptr,
        ]
        lib.matmul_launch.restype = ctypes.c_int
        _MM_LIB = lib
    return _MM_LIB


def _matmul_cuda(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major M x K)")
    w = w.contiguous()  # (K, N): small
    (m, k), n = x.shape, w.shape[1]
    dev = x.device
    with torch.cuda.device(dev):
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
        rc = _matmul_library().matmul_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
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
    w share one dtype: float32 (full-f32 products, the JAX package's
    ``HIGHEST``) or bfloat16 (products exact in f32, its ``DEFAULT``
    bf16 pass).  Any M, K and N: the JAX entry's divisibility by its
    blocks is a TPU tiling constraint, and the kernel masks ragged edges.

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
