"""Randomized SVD of the delay embedding H_d(X) without building it.

PyTorch counterpart of the fused single-device path of
``dmd_era5_tpu/ops/hankel.py``.  Row block j of H_d(X) is
X[:, j : j+T-d+1] (delay coordinate d-1-j), so H_d(X) @ Omega for every
block at once is ONE product X @ W with the (T, d*r) stacked sketch W
of :func:`stacked_sketch_matrix`, and each power iteration is one
fused pass of ``ops.matmul.sketch_center_gram_project`` over X.
"""

from __future__ import annotations

import torch

from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project
from dmd_era5_tpu_torch.ops.svd import SVDResult, _svd_flip_v_based, sklearn_n_iter
from dmd_era5_tpu_torch.utils.linalg import gram_whiten, orth_small

__all__ = ["stacked_sketch_matrix", "hankel_randomized_svd_fused"]

# sketch columns past n_components: 28 makes the standard k = 100 a
# 128-wide sketch (the JAX package's default)
N_OVERSAMPLES = 28


def stacked_sketch_matrix(omega: torch.Tensor, d: int, t_cols: int) -> torch.Tensor:
    """W (T, d*r): column block j is Omega with rows shifted down by j."""
    t_out, r = omega.shape
    if t_out != t_cols - d + 1:
        raise ValueError(f"omega {tuple(omega.shape)} does not fit d={d}, T={t_cols}")
    w = omega.new_zeros((t_cols, d * r))
    for j in range(d):
        w[j : j + t_out, j * r : (j + 1) * r] = omega
    return w


def hankel_randomized_svd_fused(
    x: torch.Tensor,
    d: int,
    n_components: int,
    generator: torch.Generator | None = None,
    gemm_dtype: torch.dtype = torch.bfloat16,
) -> SVDResult:
    """Fused-kernel randomized SVD of H_d(X), x (S, T) on one device.

    Draws the (T-d+1, n_components + N_OVERSAMPLES) Gaussian sketch from
    ``generator`` (a fresh one seeded 0 on x's device when None) and
    runs :func:`hankel_randomized_svd_fused_core`.
    """
    t_out = x.shape[1] - d + 1
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    omega = torch.randn(
        (t_out, n_components + N_OVERSAMPLES),
        generator=generator, dtype=torch.float32, device=x.device,
    )
    return hankel_randomized_svd_fused_core(x, d, n_components, omega, gemm_dtype=gemm_dtype)


def hankel_randomized_svd_fused_core(
    x: torch.Tensor,
    d: int,
    n_components: int,
    omega: torch.Tensor,
    gemm_dtype: torch.dtype = torch.bfloat16,
) -> SVDResult:
    """The SVD given its sketch omega (T-d+1, r).

    sklearn's n_iter='auto' rule sets the power iterations.  Each of the
    n_iter + 1 passes returns from one read of X
    y_wide = X W (S, d*r), G_wide = y_wide^T y_wide and
    C_wide = y_wide^T X; Y^T Y is the sum of G_wide's diagonal r x r
    blocks and B = Q^T H_d(X) follows from the CholQR2 whitener and the
    column-shifted sum of C_wide's blocks.  U is lifted one delay block
    at a time from its own column slice of y_wide, so no reshaped copy
    of y_wide is made.  U has the embedded row layout: delay block j at
    rows [j*S, (j+1)*S).
    """
    s_rows, t_cols = x.shape
    t_out = t_cols - d + 1
    n_random = omega.shape[1]
    n_iter = sklearn_n_iter(n_components, (s_rows * d, t_out))
    xg = x.to(gemm_dtype)
    omega = omega.to(device=x.device, dtype=torch.float32)

    def fused_pass(z):
        w = stacked_sketch_matrix(z, d, t_cols).to(gemm_dtype)
        y_wide, _, _, g_wide, c_wide = sketch_center_gram_project(
            xg, w, out_dtype=gemm_dtype, center=False
        )
        g = sum(
            g_wide[j * n_random : (j + 1) * n_random, j * n_random : (j + 1) * n_random]
            for j in range(d)
        )
        c_h = sum(
            c_wide[j * n_random : (j + 1) * n_random, j : j + t_out] for j in range(d)
        )
        inv_chol = gram_whiten(g, base_ridge=1e-6)
        return y_wide, inv_chol, inv_chol @ c_h  # b = Q^T H, Q = Y L^-T implicit

    z = omega
    for _ in range(n_iter):
        _, _, b = fused_pass(z)
        z = orth_small(b.T)
    y_wide, inv_chol, b = fused_pass(z)

    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    lift = inv_chol.T @ u_b[:, :n_components]  # (r, k)
    u = torch.empty((d * s_rows, n_components), dtype=torch.float32, device=x.device)
    for j in range(d):
        y_j = y_wide[:, j * n_random : (j + 1) * n_random].float()
        torch.matmul(y_j, lift, out=u[j * s_rows : (j + 1) * s_rows])
    del y_wide
    u, vt = _svd_flip_v_based(u, vt[:n_components])
    return SVDResult(u, s[:n_components], vt)
