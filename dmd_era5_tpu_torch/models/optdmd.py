"""Optimized DMD via variable projection (Askham & Kutz).

PyTorch counterpart of ``dmd_era5_tpu/models/optdmd.py``: fit

    H ~ Phi(alpha) B,   Phi(alpha)_{i,j} = exp(alpha_j t_i)

over r complex continuous-time eigenvalues alpha, with B eliminated by
least squares, minimized by Levenberg-Marquardt.  The fit runs in the
POD-projected space, H = (diag(s) V)^T of shape (T, k), on the device
of the SVD factors; complex arithmetic stays on that device.

The Jacobian over the 2r real parameters comes from ``torch.func.jacfwd``
through the normal-equations solve (Cholesky has a forward-mode rule, so
no custom derivative is needed).  The two nested ``lax.while_loop``s of
the JAX version are capped Python loops with the same accept/reject
logic: at most ``max_iter`` LM steps, and a damping escalation capped at
lambda = 1e12.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from dmd_era5_tpu_torch.utils.linalg import complex_lstsq, eig_sorted, spd_solve

__all__ = ["OptDMDResult", "varpro_lm", "optdmd_from_svd"]

# LM damping: start, raise on a rejected step, lower on an accepted one,
# cap (the JAX package's defaults; no caller changes them)
_LAMBDA0, _LAMBDA_UP, _LAMBDA_DOWN, _LAMBDA_CAP = 1.0, 4.0, 5.0, 1e12
# relative ridge on the equilibrated normal equations of B
_RIDGE = 1e-7


class OptDMDResult(NamedTuple):
    """alpha (r,) complex eigenvalues; modes (S, r) complex unit columns;
    amplitudes (r,) real; b_proj (r, k) complex coefficients in the POD
    basis; residual ||H - Phi B|| / ||H||; n_iters LM steps taken."""

    alpha: torch.Tensor
    modes: torch.Tensor
    amplitudes: torch.Tensor
    b_proj: torch.Tensor
    residual: torch.Tensor
    n_iters: int


def _phi_matrix(alpha: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Phi(alpha) = exp(t outer alpha), shape (T, r)."""
    return torch.exp(t.to(alpha.dtype)[:, None] * alpha[None, :])


def _solve_b(phi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """B = argmin ||Phi B - H||, (r, k), on a column-equilibrated basis.

    With D = diag(1/||phi_j||), solve (Phi D) Y = H and return B = D Y:
    the same B, but the normal matrix has a unit diagonal, so strongly
    damped columns do not drive the f32 Gram singular.  B does not
    depend on D, so D carries no derivative.  A 1e-7 ridge on the unit
    diagonal keeps fully underflowed columns solvable.
    """
    scale = (1.0 / torch.clamp(torch.linalg.vector_norm(phi, dim=-2), min=1e-30)).detach()
    y = complex_lstsq(phi * scale[None, :], h, _RIDGE)
    return y * scale[:, None]


def _unpack(theta: torch.Tensor) -> torch.Tensor:
    r = theta.shape[0] // 2
    return torch.complex(theta[:r], theta[r:])


def _jacfwd():
    """``torch.func.jacfwd``, with forward-AD's decomposition table loaded
    once outside the caller's warning filters (loading it emits a
    DeprecationWarning from inside torch)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import torch._decomp.decompositions_for_jvp  # noqa: F401
    return torch.func.jacfwd


def varpro_lm(
    h: torch.Tensor,
    t: torch.Tensor,
    alpha0: torch.Tensor,
    max_iter: int = 50,
    tol: float = 1e-7,
):
    """Levenberg-Marquardt over alpha with B eliminated by projection.

    h: (T, k) complex data; t: (T,) sample times; alpha0: (r,) complex
    initial eigenvalues, all on one device.  Returns
    (alpha, B, rel_residual, n_iters).
    """
    h = h.to(torch.complex64)
    t = t.to(device=h.device, dtype=torch.float32)
    alpha0 = alpha0.to(device=h.device, dtype=torch.complex64)
    h_norm = torch.linalg.vector_norm(h)

    def residual_vec(theta):
        phi = _phi_matrix(_unpack(theta), t)
        res = h - phi @ _solve_b(phi, h)
        return torch.cat([res.real.reshape(-1), res.imag.reshape(-1)])

    def res_norm(theta):
        return torch.linalg.vector_norm(residual_vec(theta))

    jacobian = _jacfwd()(residual_vec)
    theta = torch.cat([alpha0.real, alpha0.imag])
    lam = _LAMBDA0
    rnorm = res_norm(theta)
    n_iters = 0
    done = False
    # the JAX loop's was_done gate (a finished fit is a no-op) is this
    # loop's exit condition
    while n_iters < max_iter and not done:
        jac = jacobian(theta)  # (2Tk, 2r)
        res = residual_vec(theta)
        jtj = jac.T @ jac
        g = jac.T @ res
        diag = torch.diagonal(jtj)
        diag = torch.where(diag <= 0, torch.ones_like(diag), diag)

        # raise lambda until a step is accepted or lambda passes the cap
        lam_try, accepted = lam, False
        theta_try, r_try = theta, rnorm
        while not accepted and lam_try <= _LAMBDA_CAP:
            delta = spd_solve(jtj + lam_try * torch.diag(diag), g[:, None])[:, 0]
            theta_try = theta - delta
            r_try = res_norm(theta_try)
            accepted = bool(r_try < rnorm)
            if not accepted:
                lam_try *= _LAMBDA_UP

        rnorm_new = r_try if accepted else rnorm
        improved = bool((rnorm - rnorm_new) > tol * torch.clamp(rnorm, min=1e-30))
        if accepted:
            theta, lam = theta_try, lam_try / _LAMBDA_DOWN
        else:
            lam = lam_try
        rnorm = rnorm_new
        n_iters += 1
        done = not improved or not accepted

    alpha = _unpack(theta)
    b = _solve_b(_phi_matrix(alpha, t), h)
    return alpha, b, rnorm / h_norm, n_iters


def _eig_init(z: torch.Tensor, t: torch.Tensor, rank: int) -> torch.Tensor:
    """Exact-DMD eigenvalue init on the projected data z (k, T)."""
    dt = float(t[1] - t[0])
    z1, z2 = z[:, :-1], z[:, 1:]
    u, s, vt = torch.linalg.svd(z1.float(), full_matrices=False)
    u, s, vt = u[:, :rank], s[:rank], vt[:rank, :]
    atilde = (u.T @ z2) @ (vt.T / s[None, :])
    eigvals, _ = eig_sorted(atilde)
    return torch.log(eigvals) / dt


def optdmd_from_svd(
    u: torch.Tensor,
    s: torch.Tensor,
    v: torch.Tensor,
    t: torch.Tensor,
    rank: int | None = None,
    max_iter: int = 50,
    tol: float = 1e-7,
) -> OptDMDResult:
    """Optimized DMD from the truncated SVD of the snapshot matrix.

    u (S, k), s (k,), v (k, T) with components as rows, t (T,) sample
    times; rank r <= k eigenvalues (default k).  The fit sees only
    H = (diag(s) V)^T; the one S-sized product is the mode lift, done
    as two real GEMMs so no complex copy of u is made.
    """
    rank = rank or s.shape[0]
    t = t.to(device=u.device, dtype=torch.float32)
    z_proj = s[:, None] * v  # (k, T) projected snapshots
    alpha0 = _eig_init(z_proj, t, rank)
    alpha, b, rel_res, n_iters = varpro_lm(
        z_proj.T.to(torch.complex64), t, alpha0, max_iter=max_iter, tol=tol
    )
    # amplitudes: ||U B^T e_j|| = ||B[j, :]|| since U is orthonormal
    amps = torch.linalg.vector_norm(b, dim=1)
    coef = (b / torch.where(amps == 0, torch.ones_like(amps), amps)[:, None]).T
    modes = torch.complex(u @ coef.real, u @ coef.imag)
    return OptDMDResult(alpha, modes, amps, b, rel_res, n_iters)
