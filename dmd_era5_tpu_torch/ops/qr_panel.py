"""The Gram kernel of a tall panel, Cholesky QR on it, and the
Householder panel QR.

PyTorch counterpart of ``dmd_era5_tpu/ops/qr_panel.py:100-324``:
:func:`gram` (G = A^T A in one pass over A), the CholeskyQR leaves built
on it, :func:`cholqr`, :func:`cholqr2` and :func:`cholqr2_split`, and
:func:`householder_panel`.

On a CUDA tensor :func:`gram` launches the hand-written Hopper kernel
``csrc/gram.cu`` (K4 at ``"highest"``, K5 at ``"bf16_split"``) and
:func:`householder_panel` ``csrc/householder.cu`` (K7); on a CPU tensor
each takes the plain PyTorch version beside it.  There is no fallback
between the two.  ``lax.Precision`` has no torch counterpart,
so the precisions are the strings ``"highest"`` and ``"bf16_split"``.

The whitening Q = A R^-1 is one ``torch.linalg.solve_triangular``: the
JAX package's Newton-refined ``tri_inv`` worked around an inexact
triangular solve on the TPU, which a GPU does not have.
"""

from __future__ import annotations

import ctypes

import torch

from dmd_era5_tpu_torch.utils.linalg import safe_cholesky

__all__ = ["gram", "cholqr", "cholqr2", "cholqr2_split", "householder_panel", "PRECISIONS"]

PRECISIONS = ("highest", "bf16_split")
_OB = 64  # edge of the kernel's output blocks of G
_MT = 128  # rows per tile of the kernel


def _check(a: torch.Tensor, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if a.ndim != 2 or a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError(f"need a non-empty (M, K) panel, got {tuple(a.shape)}")
    dtypes = (torch.float32, torch.bfloat16) if precision == "highest" else (torch.float32,)
    if a.dtype not in dtypes:
        raise ValueError(f"precision {precision!r} takes a of dtype {dtypes}, got {a.dtype}")


def _split_gram_plain(a: torch.Tensor) -> torch.Tensor:
    """G ~= H^T H + H^T L + (H^T L)^T with H = bf16(A), L = bf16(A - H):
    the counterpart of ``dmd_era5_tpu/ops/svd.py::_split_gram_xla``.
    H and L are upcast to f32 before the products (bf16 x bf16 is exact
    there; a bf16 ``torch.mm`` would round G to 8 bits)."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.float()).to(torch.bfloat16)
    hf, lf = hi.float(), lo.float()
    del hi, lo
    ghl = hf.T @ lf
    return hf.T @ hf + ghl + ghl.T


def _gram_plain(a: torch.Tensor, precision: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 products (TF32 off on a
    card), summed in f32 by the library."""
    if precision == "bf16_split":
        return _split_gram_plain(a)
    af = a.float()
    return af.T @ af


_LIB = None


def _kernel_library():
    global _LIB
    if _LIB is None:
        from dmd_era5_tpu_torch.ops._build import load_kernel_library

        lib = load_kernel_library("gram")
        ptr, flag = ctypes.c_void_p, ctypes.c_int
        # a, per-share f64 partials, G, m, k, a_bf16, split, n_share, stream
        lib.gram_launch.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, flag, flag, flag, flag, ptr]
        lib.gram_launch.restype = ctypes.c_int
        lib.gram_ctas_per_sm.argtypes = [flag, flag, ptr]  # a_bf16, split, &out
        lib.gram_ctas_per_sm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


_CTAS_PER_SM: dict[tuple, int] = {}


def _n_share(dev, a_bf16: int, split: int, m: int, n_pairs: int) -> int:
    """Row shares: as many as fill one wave of the card's resident CTAs
    with all n_pairs blocks of G, at least 1, at most one per row tile."""
    key = (dev.index, a_bf16, split)
    if key not in _CTAS_PER_SM:
        per_sm = ctypes.c_int(0)
        rc = _kernel_library().gram_ctas_per_sm(a_bf16, split, ctypes.addressof(per_sm))
        if rc != 0 or per_sm.value < 1:
            raise RuntimeError(f"gram occupancy: CUDA error {rc}, {per_sm.value} CTAs per SM")
        _CTAS_PER_SM[key] = per_sm.value
    wave = torch.cuda.get_device_properties(dev).multi_processor_count * _CTAS_PER_SM[key]
    return max(1, min(wave // n_pairs, -(-m // _MT)))


def _gram_cuda(a: torch.Tensor, precision: str) -> torch.Tensor:
    if not a.is_contiguous():
        raise ValueError("a must be contiguous (row-major M x K)")
    m, k = a.shape
    dev = a.device
    a_bf16, split = int(a.dtype == torch.bfloat16), int(precision == "bf16_split")
    nb = -(-k // _OB)
    n_pairs = nb * (nb + 1) // 2
    with torch.cuda.device(dev):
        n_share = _n_share(dev, a_bf16, split, m, n_pairs)
        part = torch.empty((n_share, n_pairs, _OB, _OB), dtype=torch.float64, device=dev)
        g = torch.empty((k, k), dtype=torch.float32, device=dev)
        rc = _kernel_library().gram_launch(
            a.data_ptr(), part.data_ptr(), g.data_ptr(), m, k, a_bf16, split, n_share,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gram kernel: CUDA error {rc}")
    # part is released on return while the kernels may still run: the
    # caching allocator hands its memory only to later work on this stream
    gram.launches[precision] += 1
    return g


def gram(a: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """G = A^T A (K, K) float32 in one pass over A (M, K).

    Counterpart of ``dmd_era5_tpu/ops/qr_panel.py:101`` (``gram``).
    ``"highest"`` (K4) takes A in float32 or bfloat16 and full-f32
    products; ``"bf16_split"`` (K5) takes float32 A, splits it into bf16
    head and tail and forms H^T H + H^T L + (H^T L)^T (~1e-7 relative
    error, for callers whose error is quadratic in G's perturbation).
    Any K: the JAX kernel stops at K = 1024 because its K x K accumulator
    must fit VMEM, while this one's f64 scratch lives in device memory
    and grows with the number of 64 x 64 blocks of G.  The result is
    exactly symmetric on the card.

    A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
    the Hopper kernel and counts it in ``gram.launches[precision]``.
    """
    _check(a, precision)
    if a.device.type == "cpu":
        return _gram_plain(a, precision)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    return _gram_cuda(a, precision)


gram.launches = {p: 0 for p in PRECISIONS}


def _chol_r(g: torch.Tensor) -> torch.Tensor:
    """Upper-triangular R with positive diagonal from the Gram matrix,
    ridge-escalated so f32-singular panels stay finite; the counterpart
    of ``dmd_era5_tpu/ops/qr_panel.py:149``."""
    return safe_cholesky(g).T


def cholqr(a: torch.Tensor, gram_precision: str = "highest") -> tuple[torch.Tensor, torch.Tensor]:
    """Single-pass Cholesky QR: Q = A R^-1, R = chol(A^T A)^T.

    Counterpart of ``dmd_era5_tpu/ops/qr_panel.py:158``.  The whitening
    is one full-f32 triangular solve Q R = A, backward stable row by row
    (the JAX package multiplies by a refined inverse of R instead, whose
    rounding is amplified by cond(R) in Q R - A).
    """
    r = _chol_r(gram(a, precision=gram_precision))
    # solved as R^T Q^T = A^T: the solver writes its result column-major,
    # so Q^T comes back with Q row-major, as the next Gram pass needs
    q = torch.linalg.solve_triangular(r.T, a.float().T, upper=False).T
    return q.contiguous(), r


def cholqr2(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CholeskyQR2: two full-f32 CholQR passes -> orthonormal Q, R = R2 R1.
    Counterpart of ``dmd_era5_tpu/ops/qr_panel.py:182``."""
    q1, r1 = cholqr(a)
    q2, r2 = cholqr(q1)
    return q2, r2 @ r1


def cholqr2_split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CholeskyQR2 on the bf16-split Gram (K5) in both passes.

    Counterpart of ``dmd_era5_tpu/ops/qr_panel.py:189``.  The JAX
    package whitens at ``Precision.HIGH`` (bf16x3 on the TPU's matrix
    unit); here the whitening is a full-f32 product on the card.  The
    second pass corrects the first one's loss of orthogonality, so Q is
    orthonormal to ~1e-6 for panels conditioned well below
    1/sqrt(eps_f32).
    """
    q1, r1 = cholqr(a, "bf16_split")
    q2, r2 = cholqr(q1, "bf16_split")
    return q2, r2 @ r1


# ------------------------------------------------------- Householder panel

PANEL_N_MAX = 256  # widest panel of the Householder kernel (its shared arrays)


def _check_panel(a: torch.Tensor) -> None:
    if a.ndim != 2 or a.shape[1] < 1:
        raise ValueError(f"need a non-empty (m, n) panel, got {tuple(a.shape)}")
    m, n = a.shape
    if m < n:
        raise ValueError(f"householder_panel needs m >= n (R is the first n rows), got {m} x {n}")
    if n > PANEL_N_MAX:
        raise ValueError(f"householder_panel takes n <= {PANEL_N_MAX}, got {n}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"householder_panel takes float32 or bfloat16, got {a.dtype}")


def _householder_plain(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same column sweep in
    torch ops (not a library QR), f32 throughout, the sign of R's
    diagonal as the reflectors leave it."""
    m, n = a.shape
    w = a.float().clone()
    vs = torch.zeros((n, m), dtype=torch.float32, device=a.device)
    betas = torch.zeros(n, dtype=torch.float32, device=a.device)
    for j in range(n):
        tail = w[j:, j]
        ajj = tail[0]
        alpha = -torch.where(ajj >= 0, 1.0, -1.0) * torch.sqrt((tail * tail).sum())
        v = tail.clone()
        v[0] = ajj - alpha
        vtv = (v * v).sum()
        beta = torch.where(vtv > 0, 2.0 / vtv, 0.0)
        w[j:, j:] -= v[:, None] * (beta * (v @ w[j:, j:]))[None, :]
        vs[j, j:] = v
        betas[j] = beta
    r = torch.triu(w[:n])
    q = torch.eye(m, n, dtype=torch.float32, device=a.device)
    for j in reversed(range(n)):
        v = vs[j, j:]
        q[j:, j:] -= v[:, None] * (betas[j] * (v @ q[j:, j:]))[None, :]
    return q, r


_HH_LIB = None


def _householder_library():
    global _HH_LIB
    if _HH_LIB is None:
        from dmd_era5_tpu_torch.ops._build import load_kernel_library

        lib = load_kernel_library("householder")
        ptr, flag = ctypes.c_void_p, ctypes.c_int
        # a, q, r, reflector scratch, m, n, stream
        lib.householder_launch.argtypes = [ptr, ptr, ptr, ptr, flag, flag, ptr]
        lib.householder_launch.restype = ctypes.c_int
        _HH_LIB = lib
    return _HH_LIB


def _householder_cuda(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    m, n = a.shape
    dev = a.device
    with torch.cuda.device(dev):
        a = a.float().contiguous()
        q = torch.empty((m, n), dtype=torch.float32, device=dev)
        r = torch.empty((n, n), dtype=torch.float32, device=dev)
        v = torch.empty((n, m), dtype=torch.float32, device=dev)
        rc = _householder_library().householder_launch(
            a.data_ptr(), q.data_ptr(), r.data_ptr(), v.data_ptr(), m, n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"householder kernel: CUDA error {rc}")
    # v is released on return while the kernel may still run: the caching
    # allocator hands its memory only to later work on this stream
    householder_panel.launches += 1
    return q, r


def householder_panel(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Householder QR of a panel (m >= n, n <= 256): (Q (m, n), R (n, n))
    float32 with the diag(R) >= 0 convention.

    Counterpart of ``dmd_era5_tpu/ops/qr_panel.py:290`` (kernel K7).  The
    JAX kernel keeps the panel in VMEM, so its caller bounds the panel
    (``ops/tsqr.py::in_householder_kernel_envelope``); this kernel works
    in device memory and takes any m.

    A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
    the Hopper kernel and counts it in ``householder_panel.launches``.
    The sign fix is applied after either, as the JAX package applies it
    outside its kernel.
    """
    _check_panel(a)
    if a.device.type == "cpu":
        q, r = _householder_plain(a)
    elif a.device.type == "cuda":
        q, r = _householder_cuda(a)
    else:
        raise ValueError(f"no kernel for device {a.device}")
    signs = torch.sign(torch.diagonal(r))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return q * signs[None, :], r * signs[:, None]


householder_panel.launches = 0
