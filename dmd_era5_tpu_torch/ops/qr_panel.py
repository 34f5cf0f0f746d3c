"""The Gram kernel of a tall panel, Cholesky QR on it, and the
Householder panel QR.

PyTorch counterpart of ``dmd_era5_tpu/ops/qr_panel.py:100-324``:
:func:`gram` (G = A^T A in one pass over A), the CholeskyQR leaves built
on it, :func:`cholqr`, :func:`cholqr2` and :func:`cholqr2_split`, and
:func:`householder_panel`.

On a CUDA tensor :func:`gram` launches a hand-written Hopper kernel (K4
at ``"highest"``: ``csrc/atb.cu`` through ``ops/atb.py``; K5 at
``"bf16_split"``: ``csrc/gram.cu``) and
:func:`householder_panel` ``csrc/householder.cu`` (K7); on a CPU tensor
each takes the plain PyTorch version beside it.  There is no fallback
between the two.  ``lax.Precision`` has no torch counterpart,
so the precisions are the strings ``"highest"`` and ``"bf16_split"``.

The whitening Q = A R^-1 is ``torch.linalg.solve_triangular``, over
``SOLVE_ROWS`` rows of A at a time: the JAX package's Newton-refined
``tri_inv`` worked around an inexact triangular solve on the TPU, which
a GPU does not have.
"""

from __future__ import annotations

import ctypes

import torch

from dmd_era5_tpu_torch.ops import atb
from dmd_era5_tpu_torch.ops._occupancy import resident_ctas, wave_row_shares
from dmd_era5_tpu_torch.utils.linalg import safe_cholesky

__all__ = ["gram", "cholqr", "cholqr2", "cholqr2_split", "householder_panel",
           "householder_shares", "PRECISIONS"]

PRECISIONS = ("highest", "bf16_split")
# rows of A one triangular solve of cholqr takes: the library's solve on a
# narrow R (n <= 40) over 2^20 or more right-hand sides takes seconds on an
# H100 (11.1-12.2 s at 2,076,480 x 20), in blocks of 2^16 rows 2.2-2.6 ms
# in all; Q the same bit for bit there, within rounding at other widths
# (scripts/torch_trsm_rows.py)
SOLVE_ROWS = 1 << 16


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
        # a, per-share f64 partials, G, m, k, n_share, stream
        lib.gram_launch.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, flag, flag, ptr]
        lib.gram_launch.restype = ctypes.c_int
        lib.gram_ctas_per_sm.argtypes = [flag, ptr]  # k, &out
        lib.gram_ctas_per_sm.restype = ctypes.c_int
        lib.gram_upper_blocks.argtypes = [flag]  # k
        lib.gram_upper_blocks.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _split_n_share(dev, m: int, k: int) -> int:
    """Row shares of K5: whole waves of the card's resident CTAs over the
    upper blocks of G (at the block edge that the library's table gives
    width k), the f64 scratch (n_share K^2 doubles) within 1 GiB."""
    lib = _kernel_library()
    wave = resident_ctas(dev, ("gram", k), lambda out: lib.gram_ctas_per_sm(k, out))
    return wave_row_shares(wave, lib.gram_upper_blocks(k), m, 8 * k * k)


def _split_gram_cuda(a: torch.Tensor) -> torch.Tensor:
    if not a.is_contiguous():
        raise ValueError("a must be contiguous (row-major M x K)")
    m, k = a.shape
    dev = a.device
    lib = _kernel_library()
    with torch.cuda.device(dev):
        n_share = _split_n_share(dev, m, k)
        # per-share K x K, of which the upper blocks are written
        part = torch.empty((n_share, k, k), dtype=torch.float64, device=dev)
        g = torch.empty((k, k), dtype=torch.float32, device=dev)
        rc = lib.gram_launch(a.data_ptr(), part.data_ptr(), g.data_ptr(), m, k, n_share,
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gram kernel: CUDA error {rc}")
    # part is released on return while the kernels may still run: the
    # caching allocator hands its memory only to later work on this stream
    return g


def _gram_cuda(a: torch.Tensor, precision: str) -> torch.Tensor:
    g = atb.gram_cuda(a) if precision == "highest" else _split_gram_cuda(a)
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
    and grows with K^2.  The result is exactly symmetric on the card.
    On the card both run on the tensor cores with f64 tile sums: K4 in
    3xTF32 for f32 A (the counterpart of ``HIGHEST``) and one bf16 pass
    for bf16 A (its products are exact in f32), in the blocks of
    ``ops/atb.py::gram_block`` (one launch where one row share holds all
    of M), K5 in bf16 MMAs on the split.

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
    # solved as R^T Q^T = A^T a row block at a time: the solver writes its
    # result column-major, so each block of Q^T comes back with Q row-major,
    # as the next Gram pass needs
    q = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for r0 in range(0, a.shape[0], SOLVE_ROWS):
        block = a[r0 : r0 + SOLVE_ROWS].float()
        q[r0 : r0 + SOLVE_ROWS] = torch.linalg.solve_triangular(r.T, block.T, upper=False).T
    return q, r


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

PANEL_N_MAX = 256  # widest panel of the Householder kernel


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


# K7's CTAs: 256 threads each, one an SM, launched together (cooperative);
# thread (g, q) holds columns 4 q .. 4 q + 3 of at most _HH_ROWS_A_THREAD
# rows in registers, in _HH_THREADS // ceil(n / 4) row groups g
_HH_THREADS = 256
_HH_ROWS_A_THREAD = 32
# K7's CTAs by panel shape: for panels up to n_max wide, (m_max, CTAs) rows,
# the first whose m_max >= m (None: any m).  The fastest CTA count measured
# on an H100 (scripts/torch_k7_phases.py) at m = 512, 1,024, 2,048, 4,096,
# 8,760 (n = 110) and 256, 1,024, 4,096 (n = 256); one CTA for the week's
# (168, 110) iterate, whose exchange is then a block barrier.
_HH_CTAS_TABLE = (
    (128, ((256, 1), (1024, 16), (2048, 24), (4096, 33), (None, 44))),
    (256, ((1024, 16), (None, 66))),
)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _tri_padded(n: int) -> int:
    """Floats of an n x n upper triangle stored by columns, each padded to
    whole float4s (``csrc/householder.cu::cs(n)``)."""
    a, b = divmod(n, 4)
    return 4 * (a + 1) * (2 * a + b)


def _row_groups(n: int) -> int:
    return _HH_THREADS // (_round4(n) // 4)


def _householder_smem_bytes(rows_cap: int, n: int) -> int:
    """Shared memory of one K7 CTA whose share has at most ``rows_cap``
    rows: its rows of W = V T (padded to whole float4s), V_top^T, the
    reflector's column twice, the per-thread partials and the small
    vectors (``csrc/householder.cu::layout``)."""
    ns = _round4(n)
    return 4 * (rows_cap * ns + _tri_padded(n) + 2 * _HH_ROWS_A_THREAD * _row_groups(n)
                + 8 * _HH_THREADS + 8 * ns)


def _householder_rows_cap(n: int, smem_budget: int) -> int:
    """The most rows one K7 CTA holds: its shared memory and its threads'
    registers (``_HH_ROWS_A_THREAD`` rows in each row group)."""
    fixed = _householder_smem_bytes(0, n)
    by_smem = max(0, (smem_budget - fixed) // (4 * _round4(n)))
    return min(by_smem, _HH_ROWS_A_THREAD * _row_groups(n))


def householder_shares(m: int, n: int, sms: int, smem_budget: int) -> list[tuple[int, int]]:
    """K7's row shares of an (m, n) panel, one CTA each: contiguous
    ``[start, stop)`` ranges covering ``range(m)``, ``start = p m // P``.

    P comes from ``_HH_CTAS_TABLE``, is raised to the fewest CTAs whose
    shares fit ``smem_budget`` bytes of shared memory and the registers
    each (:func:`_householder_rows_cap`), and is at most
    ``sms`` (all CTAs resident, one an SM) and m.  Raises ``ValueError``
    where even ``sms`` CTAs cannot hold the panel.
    """
    if n < 1 or m < n:
        raise ValueError(f"need an (m, n) panel with m >= n >= 1, got {m} x {n}")
    cap = _householder_rows_cap(n, smem_budget)
    fit = next((p for p in range(1, min(sms, m) + 1) if -(-m // p) <= cap), None)
    if fit is None:
        raise ValueError(
            f"householder_panel: a {m} x {n} panel needs more than {sms} CTAs of "
            f"{smem_budget} bytes of shared memory (at most {cap} rows a CTA, "
            f"{cap * min(sms, m)} rows in all at n = {n})")
    by_m = next(rows for n_max, rows in _HH_CTAS_TABLE if n <= n_max)
    want = next(c for m_max, c in by_m if m_max is None or m <= m_max)
    ctas = min(max(want, fit), sms, m)
    return [(p * m // ctas, (p + 1) * m // ctas) for p in range(ctas)]


_HH_LIB = None


def _householder_library():
    global _HH_LIB
    if _HH_LIB is None:
        from dmd_era5_tpu_torch.ops._build import load_kernel_library

        lib = load_kernel_library("householder")
        ptr, flag = ctypes.c_void_p, ctypes.c_int
        # a, q, r, exchange words, V_top, m, n, CTAs, stream
        lib.householder_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, flag, flag, flag, ptr]
        lib.householder_launch.restype = ctypes.c_int
        lib.householder_smem_optin.argtypes = [flag, ptr]  # device, &out
        lib.householder_smem_optin.restype = ctypes.c_int
        _HH_LIB = lib
    return _HH_LIB


_HH_LIMITS: dict[int, tuple[int, int]] = {}


def _householder_limits(dev) -> tuple[int, int]:
    """(SMs, opt-in shared memory a CTA) of the card, cached a device."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _HH_LIMITS:
        optin = ctypes.c_int(0)
        rc = _householder_library().householder_smem_optin(index, ctypes.addressof(optin))
        if rc != 0:
            raise RuntimeError(f"householder kernel: CUDA error {rc}")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _HH_LIMITS[index] = (sms, optin.value)
    return _HH_LIMITS[index]


def _householder_launch(a: torch.Tensor, ctas: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K7 on ``ctas`` CTAs, counted in
    ``householder_panel.launches``: (Q, R), diag(R) >= 0."""
    m, n = a.shape
    dev = a.device
    with torch.cuda.device(dev):
        a = a.float().contiguous()
        q = torch.empty((m, n), dtype=torch.float32, device=dev)
        r = torch.empty((n, n), dtype=torch.float32, device=dev)
        # the exchange's tagged words and the last barrier's, zero at launch
        # (a single CTA exchanges through shared memory)
        ns = _round4(n)
        xg = torch.zeros(2 * (ctas + 1) * ns + 1 if ctas > 1 else 0, dtype=torch.int64, device=dev)
        v_top = torch.empty(_tri_padded(n), dtype=torch.float32, device=dev)
        rc = _householder_library().householder_launch(
            a.data_ptr(), q.data_ptr(), r.data_ptr(), xg.data_ptr(), v_top.data_ptr(),
            m, n, ctas, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"householder kernel: CUDA error {rc}")
    # xg and v_top are released on return while the kernel may still run:
    # the caching allocator hands their memory only to later work on this stream
    householder_panel.launches += 1
    return q, r


def _householder_cuda(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    m, n = a.shape
    sms, smem = _householder_limits(a.device)
    return _householder_launch(a, len(householder_shares(m, n, sms, smem)))


def householder_panel(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Householder QR of a panel (m >= n, n <= 256): (Q (m, n), R (n, n))
    float32 with the diag(R) >= 0 convention.

    Counterpart of ``dmd_era5_tpu/ops/qr_panel.py:290`` (kernel K7).  The
    JAX kernel keeps the panel in VMEM, so its caller bounds the panel
    (``ops/tsqr.py::in_householder_kernel_envelope``); this kernel keeps
    it in the shared memory of up to one CTA an SM
    (:func:`householder_shares`) and raises ``ValueError`` on a panel
    they cannot hold (past 38,016 rows at n = 110, 10,560 at n = 256 on
    an H100, well outside that envelope).

    A CPU tensor takes the plain PyTorch version and the sign fix after
    it, as the JAX package applies it outside its kernel; a CUDA tensor
    launches the Hopper kernel, which fixes the signs itself, and counts
    it in ``householder_panel.launches``.
    """
    _check_panel(a)
    if a.device.type == "cuda":
        return _householder_cuda(a)
    if a.device.type != "cpu":
        raise ValueError(f"no kernel for device {a.device}")
    q, r = _householder_plain(a)
    signs = torch.sign(torch.diagonal(r))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return q * signs[None, :], r * signs[:, None]


householder_panel.launches = 0
