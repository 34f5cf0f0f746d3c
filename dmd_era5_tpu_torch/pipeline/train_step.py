"""The fused fit step: one kernel pass, small algebra, lift; on one device
and over a (data, space, time) mesh.

PyTorch counterpart of ``dmd_era5_tpu/pipeline/train_step.py``.  The
mean-centred matrix
Xc = X - mu 1^T is never built: ONE pass of
``ops.matmul.sketch_center_gram_project`` returns the centred sketch Yc,
the two scalars of the row statistics, G = Yc^T Yc and C = Yc^T X, and
everything after it is r-sized except the skinny lift U = Yc (W^T Ub).
The memory-lean variant (:func:`fit_step_lean`) emits no Yc and lifts U
from X itself, the centring folded into the small lift matrix.  With
Z = S_k V_k^T the loss needs no S-sized product:

    ||Xc - U Z||^2 = ||Xc||^2 - ||Z||^2,   ||Xc||^2 = ||X||^2 - T ||mu||^2.

On a mesh (:func:`fit_step`) each rank holds its (data, space, time)
block of a (B, S, T) batch and calls the axis collectives of
``parallel.collectives`` where the JAX package's ``shard_map`` body and
GSPMD place them: with the time axis whole, K1 once per local batch
entry and sums of the r-sized G, C and ||Xc||^2 over ``space``
(:func:`_fit_step_fused_sharded`); with it split, the plain products and
the time-axis sums written out (:func:`_fit_step_portable`).  The loss
sums over ``data``: only scalars cross that axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project
from dmd_era5_tpu_torch.parallel.collectives import all_gather, psum
from dmd_era5_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_SPACE, AXIS_TIME, MESH_AXES, Mesh
from dmd_era5_tpu_torch.parallel.sharding import Layout
from dmd_era5_tpu_torch.utils.linalg import gram_whiten, spd_solve
from dmd_era5_tpu_torch.utils.tensors import home_device

__all__ = [
    "FitState",
    "fit_step",
    "fit_step_fused",
    "fit_step_lean",
    "fit_ingest_pass",
    "fit_reduce_lift",
    "make_fit_step",
    "example_batch",
]

_LIFT_ROWS = 1 << 20  # rows of X upcast at a time by the lean lift


class FitState(NamedTuple):
    """u (S, k) POD basis; s (k,); v (k, T); a_red (k, k) reduced
    one-step operator; loss () relative reconstruction error.  From the
    mesh step each leaf but the loss has a leading batch axis: u
    (B_loc, S_loc, k) is this rank's rows, the rest are whole per entry,
    and the loss is over the whole batch."""

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
    sq_norm_z = (s * s).sum()
    loss = torch.sqrt(torch.clamp(sq_norm_xc - sq_norm_z, min=0.0) / (sq_norm_xc + 1e-12))
    return FitState(u, s, vt, _reduced_operator(s, vt), loss)


def _reduced_operator(s: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """A = Z2 Z1^+ with Z = S V^T (batched or not), by the ridged normal
    equations."""
    z = s[..., :, None] * vt
    z1, z2 = z[..., :-1], z[..., 1:]
    g1 = z1 @ z1.transpose(-1, -2)
    g12 = z2 @ z1.transpose(-1, -2)
    eye = torch.eye(g1.shape[-1], dtype=g1.dtype, device=g1.device)
    return spd_solve(g1 + 1e-6 * eye, g12.transpose(-1, -2)).transpose(-1, -2)


# ------------------------------------------------------------- on a mesh


def fit_step(
    x: torch.Tensor,
    omega: torch.Tensor,
    mesh: Mesh,
    n_components: int,
    gemm_dtype: torch.dtype = torch.float32,
) -> FitState:
    """One decomposition step on this rank's block of a (B, S, T) batch
    (``dmd_era5_tpu/pipeline/train_step.py:81``).

    x: this rank's (B_loc, S_loc, T_loc) block of the batch laid out
    (data, space, time) over the mesh; omega: the whole (T, r) sketch,
    alike on every rank.  Both on the mesh's device.  With the time axis
    whole each rank's rows are complete and the fused kernel runs per
    rank (:func:`_fit_step_fused_sharded`); a split time axis breaks the
    kernel's in-epilogue centring (row means need a sum across ranks
    first), so that case takes :func:`_fit_step_portable`.
    """
    if mesh.shape[AXIS_TIME] == 1:
        return _fit_step_fused_sharded(x, omega, mesh, n_components, gemm_dtype)
    return _fit_step_portable(x, omega, mesh, n_components, gemm_dtype)


def _batch_loss(sq_norm_xc: torch.Tensor, s: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """sqrt(sum_b max(||Xc_b||^2 - ||Z_b||^2, 0) / sum_b ||Xc_b||^2) over the
    whole batch: the two sums over ``data`` (one psum of two scalars)."""
    num = torch.clamp(sq_norm_xc - (s * s).sum(dim=-1), min=0.0)
    sums = psum(torch.stack([num.sum(), sq_norm_xc.sum()]), AXIS_DATA, mesh)
    return torch.sqrt(sums[0] / (sums[1] + 1e-12))


def _fit_step_fused_sharded(
    x: torch.Tensor,
    omega: torch.Tensor,
    mesh: Mesh,
    n_components: int,
    gemm_dtype: torch.dtype = torch.float32,
) -> FitState:
    """The step over (data, space) (``train_step.py:117``): per local batch
    entry one fused pass of K1 over the rank's rows, then sums of the
    (r, r) Gram, the (r, T) projection and ||Xc||^2 over ``space``, and
    the small algebra alike on every rank of a space line (the JAX
    body's: the two-pass whitener with a 1e-6 ridge, the SVD of the
    (r, T) factor, the lift).  Only O(r^2 + rT) elements cross ranks."""
    t_cols = x.shape[-1]
    om = omega.to(gemm_dtype)
    passes = [sketch_center_gram_project(xb.to(gemm_dtype), om, out_dtype=gemm_dtype)
              for xb in x]
    y = torch.stack([p[0] for p in passes])  # (B_loc, S_loc, r)
    row_sum = torch.stack([p[1] for p in passes])
    row_sumsq = torch.stack([p[2] for p in passes])
    gram = psum(torch.stack([p[3] for p in passes]), AXIS_SPACE, mesh)  # (B_loc, r, r)
    c = psum(torch.stack([p[4] for p in passes]), AXIS_SPACE, mesh)  # (B_loc, r, T)
    del passes

    mu = row_sum / t_cols  # rows are whole on each rank
    sq_norm_xc = psum(row_sumsq.sum(dim=-1) - t_cols * (mu * mu).sum(dim=-1), AXIS_SPACE, mesh)

    inv_chol = gram_whiten(gram, base_ridge=1e-6)  # (B_loc, r, r)
    c_mu = c.sum(dim=-1) / t_cols
    b_small = inv_chol @ (c - c_mu[..., None])
    ub, s, vt = torch.linalg.svd(b_small, full_matrices=False)
    ub, s, vt = ub[..., :n_components], s[..., :n_components], vt[..., :n_components, :]
    lift = inv_chol.transpose(-1, -2) @ ub  # (B_loc, r, k) == L^-T Ub
    u = y.float() @ lift
    return FitState(u, s, vt, _reduced_operator(s, vt), _batch_loss(sq_norm_xc, s, mesh))


def _fit_step_portable(
    x: torch.Tensor,
    omega: torch.Tensor,
    mesh: Mesh,
    n_components: int,
    gemm_dtype: torch.dtype = torch.float32,
) -> FitState:
    """The step for a split time axis (``train_step.py:225``), with the
    sums the JAX package leaves to GSPMD written out: the row means and
    ||X||^2 over ``time``; the sketch X_loc @ Omega_loc over ``time``
    (S_loc x r a rank: by the algorithm's nature the one S-sized sum);
    the Gram of Y and Q^T Xc over ``space``; B = Q^T Xc gathered over
    ``time`` before the small SVD.  The products are plain ``torch``
    ones in f32, their big operands rounded to ``gemm_dtype`` first (the
    JAX products' operands, summed in f32)."""

    def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a.to(gemm_dtype).float() @ b.to(gemm_dtype).float()

    t_loc = x.shape[-1]
    t_cols = t_loc * mesh.shape[AXIS_TIME]
    t0 = mesh.coords[AXIS_TIME] * t_loc
    xf = x.float()
    sums = psum(torch.cat([xf.sum(dim=-1), (xf * xf).sum(dim=(-2, -1))[:, None]], dim=1),
                AXIS_TIME, mesh)  # (B_loc, S_loc + 1): the row sums and ||X_loc rows||^2
    mu = sums[:, :-1] / t_cols
    sq_norm_xc = psum(sums[:, -1] - t_cols * (mu * mu).sum(dim=-1), AXIS_SPACE, mesh)
    del xf, sums

    col_omega = omega.float().sum(dim=0)  # (r,)
    y = psum(gemm(x, omega[t0 : t0 + t_loc]), AXIS_TIME, mesh) - mu[..., None] * col_omega
    gram = psum(y.transpose(-1, -2) @ y, AXIS_SPACE, mesh)
    inv_chol = gram_whiten(gram, base_ridge=1e-6)
    q = y @ inv_chol.transpose(-1, -2)
    # B = Q^T X - (Q^T mu) 1^T, summed over the rank's rows and then over space
    part = gemm(q.transpose(-1, -2), x) - q.transpose(-1, -2) @ mu[..., None]
    b_small = all_gather(psum(part, AXIS_SPACE, mesh), AXIS_TIME, mesh, axis=-1, tiled=True)

    ub, s, vt = torch.linalg.svd(b_small, full_matrices=False)
    ub, s, vt = ub[..., :n_components], s[..., :n_components], vt[..., :n_components, :]
    u = q @ ub
    return FitState(u, s, vt, _reduced_operator(s, vt), _batch_loss(sq_norm_xc, s, mesh))


def make_fit_step(mesh: Mesh, n_components: int, gemm_dtype: torch.dtype = torch.float32):
    """The mesh step taking the WHOLE batch (``train_step.py:667``): the
    returned ``step(x, omega)`` cuts this rank's (data, space, time) block
    of x (B, S, T) (numpy or a tensor; each axis must divide its mesh
    axis) and moves it and omega (T, r) to the mesh's device, as the
    JAX step's input shardings place a host batch, then runs
    :func:`fit_step` on them."""
    layout = Layout(mesh, MESH_AXES)

    def step(x, omega) -> FitState:
        x_loc = layout.local_block(torch.as_tensor(x)).to(mesh.device)
        return fit_step(x_loc, torch.as_tensor(omega).to(mesh.device), mesh,
                        n_components, gemm_dtype)

    return step


def example_batch(batch: int, s_rows: int, t_cols: int, sketch: int, seed: int = 0,
                  device: torch.device | str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic example inputs for dry runs (``train_step.py:679``):
    standard normal x (B, S, T) and omega (T, r) in f32, drawn from an
    explicit generator seeded with ``seed`` on ``device`` (default: the
    card).  The parity tests feed numpy draws to both packages instead:
    the two packages' generators differ."""
    device = home_device(None, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, s_rows, t_cols), generator=gen, device=device)
    omega = torch.randn((t_cols, sketch), generator=gen, device=device)
    return x, omega
