"""Truncated SVD of a tall snapshot matrix on one device.

PyTorch counterpart of the single-device part of
``dmd_era5_tpu/ops/svd.py`` (:56-76, :101-265, :275-378, :496-546):

- ``"standard"``: the exact SVD, by the Gram route (one Gram pass,
  ``eigh``, one fused Rayleigh-Ritz pass; the tall-skinny default) or
  the TSQR route (QR of X, SVD of the small R);
- ``"randomized"``: sklearn's randomized SVD, re-orthonormalizing the
  sketch through the TSQR leaf at every power iteration;

and the result container, sklearn's v-based sign flip and its
``n_iter='auto'`` rule.  The exact routes do not flip signs; only the
randomized one does, as sklearn does.  ``pallas_ok`` and the plain
fallbacks it selected exist only for a CPU mesh under a TPU backend and
are gone, and so are the mesh arguments.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project
from dmd_era5_tpu_torch.ops.qr_panel import gram
from dmd_era5_tpu_torch.ops.tsqr import _local_factor, default_qr_method, tsqr
from dmd_era5_tpu_torch.utils.linalg import gram_whiten, orth_small

__all__ = [
    "SVDResult",
    "exact_truncated_svd",
    "exact_truncated_svd_gram",
    "randomized_svd",
    "truncated_svd",
    "sklearn_n_iter",
]


class SVDResult(NamedTuple):
    """U (S, k), s (k,) and V (k, T) with rows as components."""

    U: torch.Tensor
    s: torch.Tensor
    V: torch.Tensor


def _svd_flip_v_based(U: torch.Tensor, V: torch.Tensor):
    """Deterministic signs via the max-|.| entry of each right singular
    vector (sklearn's ``svd_flip(u_based_decision=False)``).

    Scales U IN PLACE (it is S-sized; a copy would double the basis's
    memory) and returns (U, flipped copy of V).
    """
    max_idx = torch.argmax(V.abs(), dim=1)
    signs = torch.sign(V[torch.arange(V.shape[0], device=V.device), max_idx])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return U.mul_(signs[None, :]), V * signs[:, None]


def sklearn_n_iter(n_components: int, shape: tuple[int, int]) -> int:
    """sklearn's n_iter='auto' rule: 7 if k < 0.1 * min(shape) else 4."""
    return 7 if n_components < 0.1 * min(shape) else 4


def _lane_width(n_components: int, t_cols: int) -> int:
    """The Rayleigh-Ritz subspace width of the exact routes: k rounded up
    to a multiple of 128, at most T.  The JAX package widens for its
    lanes; the extra exact eigenvectors change the Rayleigh-Ritz space,
    so the port keeps the width (``dmd_era5_tpu/ops/svd.py:187-191``)."""
    return min(-(-n_components // 128) * 128, t_cols)


# ---------------------------------------------------------------- exact


def exact_truncated_svd(x: torch.Tensor, n_components: int) -> SVDResult:
    """Exact truncated SVD of a tall (S, T) matrix by TSQR.

    Counterpart of ``dmd_era5_tpu/ops/svd.py:101``: X = Q R with the
    default leaf (:func:`ops.tsqr.default_qr_method`), the SVD of the
    (T, T) R, and U = Q U_R.  The lift is full f32 (the JAX package's is
    ``Precision.HIGH``, bf16x3 on a TPU).
    """
    q, r = tsqr(x)
    u_r, s, vt = torch.linalg.svd(r, full_matrices=False)
    u = q @ u_r[:, :n_components]
    return SVDResult(u, s[:n_components], vt[:n_components, :])


def raw_gram(x: torch.Tensor, gram_precision: str) -> torch.Tensor:
    """X^T X at the requested precision (``dmd_era5_tpu/ops/svd.py:131``):
    the Gram kernel at every T.  The JAX package leaves T > 1024 to XLA's
    f32 sums, a VMEM limit of its Pallas kernel.  f32 sums over millions
    of rows make G indefinite in its noise directions, and this kernel,
    which sums in f64, has no such limit."""
    return gram(x, precision=gram_precision)


def _gram_route_core(x: torch.Tensor, n_components: int, gram_precision: str = "highest"):
    """Gram-route exact SVD (``dmd_era5_tpu/ops/svd.py:150``).

    1. G = X^T X (one pass over X, the Gram kernel);
    2. ``eigh(G)`` gives the exact top right subspace V_k, widened to
       :func:`_lane_width`; ONE fused pass (``sketch_center_gram_project``,
       centring off) gives y = X V_k, G_y = y^T y and C = y^T X;
    3. the CholQR2 whitener W of G_y makes Q = y W^T orthonormal without
       forming it; B = Q^T X = W C is small, and its SVD restores the
       singular values to f32 accuracy; U = y (W^T U_b).
    """
    g = raw_gram(x, gram_precision)
    _, vecs = torch.linalg.eigh(g)  # ascending eigenvalues
    k_pad = _lane_width(n_components, x.shape[1])
    v_k = vecs.flip(-1)[:, :k_pad].to(x.dtype).contiguous()
    y, _, _, g_y, c = sketch_center_gram_project(x, v_k, center=False)
    w = gram_whiten(g_y, base_ridge=1e-7)
    u_b, s, vt = torch.linalg.svd(w @ c, full_matrices=False)
    u = y.float() @ (w.T @ u_b[:, :n_components])
    return u, s[:n_components], vt[:n_components, :]


def exact_truncated_svd_gram(
    x: torch.Tensor, n_components: int, gram_precision: str = "highest"
) -> SVDResult:
    """Exact truncated SVD via the T x T Gram matrix (T << S).

    Counterpart of ``dmd_era5_tpu/ops/svd.py:228``: the top-k subspace
    from ``eigh`` of the f32 Gram and the triplets from a Rayleigh-Ritz
    SVD through an orthonormalized basis, so the accuracy matches the
    TSQR route down to the sqrt(eps)-conditioned tail, in two passes
    over X.
    """
    return SVDResult(*_gram_route_core(x, n_components, gram_precision))


# ------------------------------------------------------------ randomized


def _rand_svd_core(
    x: torch.Tensor,
    omega: torch.Tensor,
    n_components: int,
    n_iter: int,
    gemm_dtype: torch.dtype,
    qr_method: str,
):
    """Randomized SVD given its Gaussian sketch omega (T, r)
    (``dmd_era5_tpu/ops/svd.py:275``, single device).

    The S-sized products take their inputs in ``gemm_dtype`` and sum in
    f32; each power iteration re-orthonormalizes through the TSQR leaf
    ``qr_method`` and the (T, r) iterate through ``orth_small``.
    """

    def big_gemm(a, b):
        return a.to(gemm_dtype).float() @ b.to(gemm_dtype).float()

    def orthonormalize(y):
        return _local_factor(y, qr_method)[0]

    omega = omega.to(device=x.device, dtype=torch.float32)
    q = orthonormalize(big_gemm(x, omega))
    for _ in range(n_iter):
        z = orth_small(big_gemm(x.T, q))
        q = orthonormalize(big_gemm(x, z))
    u_b, s, vt = torch.linalg.svd(q.T @ x.float(), full_matrices=False)
    # only the kept components are lifted: the flip of each depends on
    # its own row of V alone
    u = q @ u_b[:, :n_components]
    del q
    u, vt = _svd_flip_v_based(u, vt[:n_components, :])
    return u, s[:n_components], vt


def randomized_svd(
    x: torch.Tensor,
    n_components: int,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int | torch.Generator = 0,
    gemm_dtype: torch.dtype = torch.float32,
    qr_method: str | None = None,
) -> SVDResult:
    """Randomized truncated SVD of a tall (S, T) matrix.

    Counterpart of ``dmd_era5_tpu/ops/svd.py:328``: sklearn's semantics
    (k + n_oversamples Gaussian columns, n_iter='auto' rule, truncation
    to k, v-based sign flip).  The (T, k + n_oversamples) sketch is drawn
    from ``seed``, a ``torch.Generator`` on x's device or an int that
    seeds a fresh one; torch's numbers are not JAX's.
    """
    s_rows, t_cols = x.shape
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (s_rows, t_cols))
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
    omega = torch.randn(
        (t_cols, n_random), generator=gen, dtype=torch.float32, device=x.device
    )
    u, s, vt = _rand_svd_core(
        x, omega, n_components, n_iter, gemm_dtype, qr_method or default_qr_method(x)
    )
    return SVDResult(u, s, vt)


# ------------------------------------------------------------ dispatcher


def truncated_svd(
    x: torch.Tensor,
    n_components: int,
    svd_type: str = "standard",
    seed: int = 0,
    gemm_dtype: torch.dtype = torch.float32,
    exact_method: str = "auto",
    gram_precision: str = "bf16_split",
) -> SVDResult:
    """Dispatch matching ``svd_on_era5``'s semantics
    (``dmd_era5_tpu/ops/svd.py:496``).

    ``exact_method``: ``"auto"`` takes the Gram route when the matrix is
    decisively tall-skinny (T <= 4096 and S >= 4 T, the ERA5 regime) and
    TSQR otherwise; ``"gram"`` or ``"tsqr"`` force one.
    ``gram_precision`` is the Gram route's first pass: ``"bf16_split"``
    (K5, the default) or ``"highest"`` (K4).
    """
    if svd_type == "standard":
        s_rows, t_cols = x.shape
        method = exact_method
        if method == "auto":
            method = "gram" if (t_cols <= 4096 and s_rows >= 4 * t_cols) else "tsqr"
        if method == "gram":
            return exact_truncated_svd_gram(x, n_components, gram_precision=gram_precision)
        return exact_truncated_svd(x, n_components)
    if svd_type == "randomized":
        return randomized_svd(x, n_components, seed=seed, gemm_dtype=gemm_dtype)
    raise ValueError(f"SVD type {svd_type} is not supported.")
