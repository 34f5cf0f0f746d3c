"""Small-matrix linear algebra for the decomposition hot paths.

PyTorch counterpart of ``dmd_era5_tpu/utils/linalg.py``.  The r x r
factors here sit between the S-sized streaming passes; they run on
whatever device their inputs live on.  Three workarounds of the JAX
package are gone because the GPU does not need them:

- the refined triangular inverse (``tri_inv``) becomes one
  ``torch.linalg.solve_triangular``, which is exact to f32 roundoff;
- the host callback of ``eig_host`` becomes ``torch.linalg.eig`` on the
  device (:func:`eig_sorted`);
- the real block rewrite of complex solves becomes a native complex
  solve.

The two-pass whitener and the ridge escalation are kept exactly.
"""

from __future__ import annotations

import torch

__all__ = [
    "safe_cholesky",
    "gram_whiten",
    "orth_small",
    "eig_sorted",
    "spd_solve",
    "complex_solve",
    "complex_lstsq",
    "lstsq_implicit",
]


def _eye_like(g: torch.Tensor) -> torch.Tensor:
    return torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)


def _cholesky_nan(g: torch.Tensor) -> torch.Tensor:
    """Cholesky factor, NaN where the factorization fails (LAPACK's
    convention, which the ridge escalation keys on) instead of raising."""
    l, info = torch.linalg.cholesky_ex(g)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(l, float("nan")), l)


def safe_cholesky(g: torch.Tensor, base_ridge: float = 1e-7) -> torch.Tensor:
    """Cholesky of a (batched) PSD Gram matrix with ridge escalation.

    Factor with a tiny trace-relative ridge first; where that fails,
    substitute the factor of a copy ridged by 1e-3 of the mean diagonal.
    """
    k = g.shape[-1]
    diag = torch.diagonal(g, dim1=-2, dim2=-1)
    scale = torch.clamp(diag.sum(-1) / k, min=1e-30)[..., None, None]
    eye = _eye_like(g)
    l_tight = _cholesky_nan(g + base_ridge * scale * eye)
    l_loose = _cholesky_nan(g + 1e-3 * scale * eye)
    bad = (~torch.isfinite(l_tight)).any(-1, keepdim=True).any(-2, keepdim=True)
    return torch.where(bad, l_loose, l_tight)


def _tri_inv(l: torch.Tensor) -> torch.Tensor:
    eye = _eye_like(l).expand_as(l)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def gram_whiten(g: torch.Tensor, base_ridge: float = 1e-6) -> torch.Tensor:
    """Two-pass CholQR whitener W from a (batched) Gram matrix G = Y^T Y.

    Q = Y W^T is orthonormal to roundoff: W = L2^-1 L1^-1 with
    L1 = chol(G) and L2 = chol(L1^-1 G L1^-T), the CholQR2 correction
    done wholly in the small space.  Where the second factor is not
    finitely computable (cond(G) past 1/eps), W1 alone is returned.
    """
    l1 = safe_cholesky(g, base_ridge=base_ridge)
    w1 = _tri_inv(l1)
    m = w1 @ g @ w1.transpose(-1, -2)
    m = 0.5 * (m + m.transpose(-1, -2))
    l2 = safe_cholesky(m, base_ridge=base_ridge)
    w2 = _tri_inv(l2)
    bad = (~torch.isfinite(w2)).any(-1, keepdim=True).any(-2, keepdim=True)
    w2 = torch.where(bad, _eye_like(w2), w2)
    return w2 @ w1


def orth_small(z: torch.Tensor) -> torch.Tensor:
    """Orthonormalize a tall matrix via Gram whitening (Q = Z W^T)."""
    g = z.transpose(-1, -2) @ z
    w = gram_whiten(g, base_ridge=1e-6)
    return z @ w.transpose(-1, -2)


def eig_sorted(
    a: torch.Tensor, dtype: torch.dtype = torch.complex64
) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a small (batched) matrix on its own device.

    Returns (eigenvalues, eigenvectors) in ``dtype`` (complex64, as
    ``eig_host`` returns them, or complex128 for the mrDMD windows,
    whose JAX counterpart takes an f64 ``np.linalg.eig``), ordered by
    descending |eigenvalue| with a stable sort, as ``eig_host`` orders
    them.
    """
    w, v = torch.linalg.eig(a.to(dtype))
    order = torch.argsort(-w.abs(), dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    v = torch.gather(v, -1, order[..., None, :].expand_as(v))
    return w, v


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for symmetric (Hermitian) positive-definite A."""
    return torch.cholesky_solve(b, _cholesky_nan(a))


def complex_solve(
    a: torch.Tensor, b: torch.Tensor, hpd: bool = False
) -> torch.Tensor:
    """Solve A X = B for complex square A; ``hpd=True`` asserts A is
    Hermitian positive-definite and takes the Cholesky route."""
    return spd_solve(a, b) if hpd else torch.linalg.solve(a, b)


def complex_lstsq(
    a: torch.Tensor, b: torch.Tensor, rcond_ridge: float = 0.0
) -> torch.Tensor:
    """min ||A X - B|| for complex tall A via the (ridged) normal
    equations, differentiable in forward mode."""
    ah = a.mH
    gram = ah @ a
    if rcond_ridge:
        gram = gram + rcond_ridge * _eye_like(gram)
    squeeze = b.ndim != a.ndim
    rhs = ah @ (b[..., None] if squeeze else b)
    x = complex_solve(gram, rhs, hpd=True)
    return x[..., 0] if squeeze else x


# ---- least squares with an implicit-differentiation rule ---------------
#
# Counterpart of the JAX ``custom_jvp`` (``dmd_era5_tpu/utils/linalg.py:
# 283-314``).  Differentiate the normal equations instead of the solve:
#
#     G X = A^H B,  G = A^H A + rho I
#  => G dX = dA^H B + A^H dB - (dA^H A + A^H dA) X
#          = dA^H R + A^H (dB - dA X),   R = B - A X,
#
# one more solve with the primal G a tangent.  The rule is real-linear in
# dA, so it is the forward derivative of complex inputs as they are.  Its
# adjoint under Re<u, v> = Re tr(u^H v) (PyTorch's convention for complex
# gradients, and what JAX's transposed JVP gives) is, with W = G^-1 gX,
#
#     gA = R W^H - A W X^H,   gB = A W.


def _as_columns(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return b if b.ndim == a.ndim else b[..., None]


def _normal_gram(a: torch.Tensor, ridge: float) -> torch.Tensor:
    gram = a.mH @ a
    return gram + ridge * _eye_like(gram) if ridge else gram


class _LstsqImplicit(torch.autograd.Function):
    generate_vmap_rule = True  # torch.func.jacfwd and vmap run the rules batched

    @staticmethod
    def forward(a, b, ridge):
        return complex_lstsq(a, b, rcond_ridge=ridge)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, ridge = inputs
        ctx.ridge = ridge
        ctx.save_for_forward(a, b, output)
        ctx.save_for_backward(a, b, output)

    @staticmethod
    def jvp(ctx, da, db, _):
        a, b, x = ctx.saved_tensors
        b2, x2 = _as_columns(b, a), _as_columns(x, a)
        rhs = []  # an input without a tangent comes as None
        if da is not None:
            rhs.append(da.mH @ (b2 - a @ x2) - a.mH @ (da @ x2))
        if db is not None:
            rhs.append(a.mH @ _as_columns(db, a))
        dx = complex_solve(_normal_gram(a, ctx.ridge), sum(rhs), hpd=True)
        return dx if b.ndim == a.ndim else dx[..., 0]

    @staticmethod
    def backward(ctx, gx):
        a, b, x = ctx.saved_tensors
        b2, x2 = _as_columns(b, a), _as_columns(x, a)
        w = complex_solve(_normal_gram(a, ctx.ridge), _as_columns(gx, a), hpd=True)
        aw = a @ w
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (b2 - a @ x2) @ w.mH - aw @ x2.mH
        if ctx.needs_input_grad[1]:
            gb = aw if b.ndim == a.ndim else aw[..., 0]
        return ga, gb, None


def lstsq_implicit(a: torch.Tensor, b: torch.Tensor, ridge: float = 0.0) -> torch.Tensor:
    """``complex_lstsq(a, b, ridge)`` whose derivatives come from the
    normal equations (the rule above): forward mode (``torch.func.jvp``,
    ``jacfwd``) solves once more with the primal Gram a tangent, reverse
    mode once a cotangent.  ``b`` (..., M, K) or (..., M)."""
    return _LstsqImplicit.apply(a, b, ridge)
