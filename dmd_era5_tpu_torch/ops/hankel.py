"""SVDs of the delay embedding H_d(X) without building it.

PyTorch counterpart of the single-device paths of
``dmd_era5_tpu/ops/hankel.py``: the fused randomized SVD and the exact
one.  Row block j of H_d(X) is X[:, j : j+T-d+1] (delay coordinate
d-1-j), so H_d(X) @ Omega for every block at once is ONE product X @ W
with the (T, d*r) stacked sketch W of :func:`stacked_sketch_matrix`,
and each pass over X is one fused ``ops.matmul.sketch_center_gram_project``.
U has the embedded row layout: delay block j at rows [j*S, (j+1)*S),
lifted one block at a time from its own column slice of the pass's
y_wide, so no reshaped copy of y_wide is made.
"""

from __future__ import annotations

import torch

from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project
from dmd_era5_tpu_torch.ops.svd import (
    SVDResult,
    _lane_width,
    _svd_flip_v_based,
    raw_gram,
    sklearn_n_iter,
)
from dmd_era5_tpu_torch.utils.linalg import gram_whiten, orth_small

__all__ = [
    "stacked_sketch_matrix",
    "hankel_randomized_svd_fused",
    "hankel_randomized_svd_fused_core",
    "hankel_exact_svd",
]

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
    u = _lift_blocks(y_wide, inv_chol.T @ u_b[:, :n_components], d)
    del y_wide
    u, vt = _svd_flip_v_based(u, vt[:n_components])
    return SVDResult(u, s[:n_components], vt)


def _lift_blocks(y_wide: torch.Tensor, lift: torch.Tensor, d: int) -> torch.Tensor:
    """U (d*S, k) f32: delay block j is y_wide's j-th column slice times
    lift (r, k), written in place into its row block of U."""
    s_rows, r = y_wide.shape[0], y_wide.shape[1] // d
    u = torch.empty((d * s_rows, lift.shape[1]), dtype=torch.float32, device=y_wide.device)
    for j in range(d):
        torch.matmul(y_wide[:, j * r : (j + 1) * r].float(), lift, out=u[j * s_rows : (j + 1) * s_rows])
    return u


def hankel_exact_svd(
    x: torch.Tensor, d: int, n_components: int, gram_precision: str = "bf16_split"
) -> SVDResult:
    """Exact truncated SVD of H_d(X), x (S, T) on one device.

    Counterpart of ``dmd_era5_tpu/ops/hankel.py:474-602`` (single
    device), the deterministic (``svd_type="standard"``) sibling of
    :func:`hankel_randomized_svd_fused`, in two passes over the raw X:

    1. the raw Gram G = X^T X (``ops.svd.raw_gram``: the Gram kernel,
       bf16-split by default); the embedded Gram follows from the banded
       identity (H^T H)[i, j] = sum_b G[i+b, j+b], and its ``eigh`` gives
       the exact top right subspace V_k, widened as in the Gram route;
    2. ONE fused pass with the stacked shift of V_k gives y_wide, whose
       diagonal Gram blocks sum to y^T y and whose shifted projection
       blocks sum to y^T H; the CholQR2 whitener and a small SVD then
       restore the triplets to f32 accuracy.

    No signs are flipped (the JAX function flips none).
    """
    t_cols = x.shape[1]
    t_out = t_cols - d + 1
    g_raw = raw_gram(x, gram_precision)
    g_h = sum(g_raw[b : b + t_out, b : b + t_out] for b in range(d))
    _, vecs = torch.linalg.eigh(g_h)  # ascending
    k_pad = _lane_width(n_components, t_out)
    v_k = vecs.flip(-1)[:, :k_pad].contiguous()
    w = stacked_sketch_matrix(v_k, d, t_cols).to(x.dtype)
    y_wide, _, _, g_wide, c_wide = sketch_center_gram_project(x, w, center=False)
    g_y = sum(g_wide[j * k_pad : (j + 1) * k_pad, j * k_pad : (j + 1) * k_pad] for j in range(d))
    c_h = sum(c_wide[j * k_pad : (j + 1) * k_pad, j : j + t_out] for j in range(d))
    w_wh = gram_whiten(g_y, base_ridge=1e-7)
    u_b, s, vt = torch.linalg.svd(w_wh @ c_h, full_matrices=False)
    u = _lift_blocks(y_wide, w_wh.T @ u_b[:, :n_components], d)
    return SVDResult(u, s[:n_components], vt[:n_components, :])
