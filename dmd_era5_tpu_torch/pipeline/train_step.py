"""The fused fit step on one device: one kernel pass, small algebra, lift.

PyTorch counterpart of the single-device part of
``dmd_era5_tpu/pipeline/train_step.py``.  The mean-centred matrix
Xc = X - mu 1^T is never built: ONE pass of
``ops.matmul.sketch_center_gram_project`` returns the centred sketch Yc,
the two scalars of the row statistics, G = Yc^T Yc and C = Yc^T X, and
everything after it is r-sized except the skinny lift U = Yc (W^T Ub).
The memory-lean variant (:func:`fit_step_lean`) emits no Yc and lifts U
from X itself, the centring folded into the small lift matrix.  With
Z = S_k V_k^T the loss needs no S-sized product:

    ||Xc - U Z||^2 = ||Xc||^2 - ||Z||^2,   ||Xc||^2 = ||X||^2 - T ||mu||^2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project
from dmd_era5_tpu_torch.utils.linalg import gram_whiten, spd_solve

__all__ = [
    "FitState",
    "fit_step_fused",
    "fit_step_lean",
    "fit_ingest_pass",
    "fit_reduce_lift",
]

_LIFT_ROWS = 1 << 20  # rows of X upcast at a time by the lean lift


class FitState(NamedTuple):
    """u (S, k) POD basis; s (k,); v (k, T); a_red (k, k) reduced
    one-step operator; loss () relative reconstruction error."""

    u: torch.Tensor
    s: torch.Tensor
    v: torch.Tensor
    a_red: torch.Tensor
    loss: torch.Tensor


def fit_step_fused(
    x: torch.Tensor,
    omega: torch.Tensor,
    n_components: int,
    gemm_dtype: torch.dtype = torch.float32,
    stats_from_sketch: bool = False,
    t_valid: int | None = None,
    small_algebra: str = "hybrid",
) -> FitState:
    """Single-device fused fit step on an (S, T) snapshot matrix.

    ``stats_from_sketch`` spends omega's last column on an all-ones
    probe so the row sums come out of the sketch product.  ``t_valid``:
    the trailing columns of x past it are zero padding.
    """
    y, sq_norm_xc, gram, c = fit_ingest_pass(
        x, omega, gemm_dtype=gemm_dtype,
        stats_from_sketch=stats_from_sketch, t_valid=t_valid,
    )
    return fit_reduce_lift(
        y, sq_norm_xc, gram, c, n_components=n_components,
        t_valid=t_valid, small_algebra=small_algebra,
    )


def fit_step_lean(
    x: torch.Tensor,
    omega: torch.Tensor,
    n_components: int,
    gemm_dtype: torch.dtype = torch.float32,
    u_dtype: torch.dtype | None = None,
    t_valid: int | None = None,
    small_algebra: str = "hybrid",
) -> FitState:
    """Memory-lean fit step: device memory holds ONE extra S-sized array.

    Counterpart of ``dmd_era5_tpu/pipeline/train_step.py:365``: the same
    math as :func:`fit_step_fused`, but the pass emits no Yc
    (``emit_yc=False``) and U comes from one more product with X, the
    centring folded into the small lift matrix:

        U = Xc (Omega W Ub) = X (M - (1/T) 1_valid (1_valid^T M)),
        M = Omega W Ub.

    U is float32 (``u_dtype=None``) or ``u_dtype``.
    """
    t_pad = x.shape[1]
    t_cols = t_valid if t_valid is not None else t_pad
    xg = x.to(gemm_dtype)
    _, rs_sq_sum, sumsq_sum, gram, c = sketch_center_gram_project(
        xg, omega.to(gemm_dtype), out_dtype=gemm_dtype, scalar_stats=True,
        t_valid=t_valid, emit_yc=False,
    )
    c_centered = _centred_projection(c, t_valid)
    w_lift, s, vt = _reduced_factors(gram, c_centered, n_components, method=small_algebra)
    vt = vt[:n_components, :t_cols]

    m_small = omega.float() @ w_lift  # (T_pad, k)
    valid = torch.ones((t_pad, 1), dtype=torch.float32, device=x.device)
    valid[t_cols:] = 0.0
    m_fold = m_small - (valid / t_cols) * (m_small * valid).sum(dim=0, keepdim=True)
    if u_dtype is None or u_dtype == torch.float32:
        # row chunks: a bf16 X is upcast a chunk at a time, never whole
        u = torch.empty((x.shape[0], m_fold.shape[1]), dtype=torch.float32, device=x.device)
        for r0 in range(0, x.shape[0], _LIFT_ROWS):
            torch.matmul(xg[r0 : r0 + _LIFT_ROWS].float(), m_fold, out=u[r0 : r0 + _LIFT_ROWS])
    else:
        u = (xg @ m_fold.to(gemm_dtype)).to(u_dtype)
    return _dynamics_and_loss(u, s, vt, sumsq_sum - rs_sq_sum / t_cols)


def fit_ingest_pass(
    x: torch.Tensor,
    omega: torch.Tensor,
    gemm_dtype: torch.dtype = torch.float32,
    stats_from_sketch: bool = False,
    t_valid: int | None = None,
):
    """Stage 1 of the fused fit: ONE kernel pass over X.

    Returns (Yc, ||Xc||^2, G, C).  Yc is stored in ``gemm_dtype`` and G
    and C come from the stored Yc.
    """
    t_cols = t_valid if t_valid is not None else x.shape[1]
    y, rs_sq_sum, sumsq_sum, gram, c = sketch_center_gram_project(
        x.to(gemm_dtype),
        omega.to(gemm_dtype),
        out_dtype=gemm_dtype,
        stats_col=stats_from_sketch,
        scalar_stats=True,
        t_valid=t_valid,
    )
    return y, sumsq_sum - rs_sq_sum / t_cols, gram, c


def _reduced_factors(
    gram: torch.Tensor,
    c_centered: torch.Tensor,
    n_components: int,
    method: str = "cholqr",
):
    """(w_lift, s, vt_full) of the sketch-subspace SVD, small algebra.

    With G = Yc^T Yc and C = Yc^T Xc, the SVD of B = W C for a whitener
    W with (Yc W^T) orthonormal; U = Yc @ w_lift.

    - "hybrid" (default of the fit step): the CholQR2 whitener and one
      r x r eigh of K = B B^T.  Components below ~sqrt(eps) of s[0]
      are noise-floor (shrunk, never grown).
    - "cholqr": the whitener and the SVD of the (r, T) factor B.
    - "eigh2": W = G^{-1/2} from eigh(G), then eigh of W (C C^T) W, with
      G's eigenvalues floored at 6e-7 of the largest.
    """
    if method == "cholqr":
        inv_chol = gram_whiten(gram, base_ridge=1e-6)
        b_small = inv_chol @ c_centered
        ub, s, vt = torch.linalg.svd(b_small, full_matrices=False)
        return inv_chol.T @ ub[:, :n_components], s[:n_components], vt

    if method == "hybrid":
        inv_chol = gram_whiten(gram, base_ridge=1e-6)
        b_small = inv_chol @ c_centered
        eh, uh = torch.linalg.eigh(b_small @ b_small.T)  # ascending
        s = torch.sqrt(torch.clamp(eh.flip(0), min=0.0))[:n_components]
        ub = uh.flip(1)[:, :n_components]
        vt = (ub.T @ b_small) / torch.clamp(s, min=1e-30)[:, None]
        return inv_chol.T @ ub, s, vt

    if method != "eigh2":
        raise ValueError(f"small_algebra must be cholqr/eigh2/hybrid, got {method!r}")

    e, vg = torch.linalg.eigh(gram)  # ascending
    e0 = torch.clamp(e[-1], min=1e-30)
    inv_sqrt = 1.0 / torch.sqrt(torch.maximum(e, 6e-7 * e0))
    w = (vg * inv_sqrt[None, :]) @ vg.T  # symmetric G^{-1/2}
    h = w @ (c_centered @ c_centered.T) @ w
    eh, uh = torch.linalg.eigh(h)
    s = torch.sqrt(torch.clamp(eh.flip(0), min=0.0))[:n_components]
    ub = uh.flip(1)[:, :n_components]
    w_lift = w @ ub
    vt = (w_lift.T @ c_centered) / torch.clamp(s, min=1e-30)[:, None]
    return w_lift, s, vt


def fit_reduce_lift(
    y: torch.Tensor,
    sq_norm_xc: torch.Tensor,
    gram: torch.Tensor,
    c: torch.Tensor,
    n_components: int,
    t_valid: int | None = None,
    small_algebra: str = "hybrid",
) -> FitState:
    """Stage 2 of the fused fit: small algebra and the skinny U lift
    (U in float32)."""
    t_cols = t_valid if t_valid is not None else c.shape[1]
    c_centered = _centred_projection(c, t_valid)
    w_lift, s, vt = _reduced_factors(gram, c_centered, n_components, method=small_algebra)
    vt = vt[:n_components, :t_cols]
    return _dynamics_and_loss(y.float() @ w_lift, s, vt, sq_norm_xc)


def _centred_projection(c: torch.Tensor, t_valid: int | None) -> torch.Tensor:
    """C - c_mu 1^T with c_mu = C 1 / t_valid, the mean subtracted only
    on the true columns: pad columns stay zero."""
    t_cols = t_valid if t_valid is not None else c.shape[1]
    c_centered = c - (c.sum(dim=1) / t_cols)[:, None]
    if t_cols != c.shape[1]:
        c_centered[:, t_cols:] = 0.0
    return c_centered


def _dynamics_and_loss(u, s, vt, sq_norm_xc) -> FitState:
    """The reduced one-step operator and the loss from the factors."""
    z = s[:, None] * vt
    z1, z2 = z[:, :-1], z[:, 1:]
    g1 = z1 @ z1.T
    g12 = z2 @ z1.T
    eye = torch.eye(g1.shape[-1], dtype=g1.dtype, device=g1.device)
    a_red = spd_solve(g1 + 1e-6 * eye, g12.T).T

    sq_norm_z = (s * s).sum()
    loss = torch.sqrt(torch.clamp(sq_norm_xc - sq_norm_z, min=0.0) / (sq_norm_xc + 1e-12))
    return FitState(u, s, vt, a_red, loss)
