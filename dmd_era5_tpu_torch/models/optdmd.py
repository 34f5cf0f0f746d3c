"""Optimized DMD via variable projection (Askham & Kutz).

PyTorch counterpart of ``dmd_era5_tpu/models/optdmd.py``: fit

    H ~ Phi(alpha) B,   Phi(alpha)_{i,j} = exp(alpha_j t_i)

over r complex continuous-time eigenvalues alpha, with B eliminated by
least squares, minimized by Levenberg-Marquardt.  The fit runs in the
POD-projected space, H = (diag(s) V)^T of shape (T, k), on the device
of the SVD factors; complex arithmetic stays on that device.

The Jacobian over the 2r real parameters comes from forward-mode
products (``torch.func.jvp``) through the normal-equations solve
(Cholesky has a forward-mode rule, so no custom derivative is needed).
The two nested ``lax.while_loop``s of the JAX version are capped Python
loops with the same accept/reject logic: at most ``max_iter`` LM steps,
and a damping escalation capped at lambda = 1e12.  One loop serves
:func:`varpro_lm` (a batch of one) and :func:`varpro_lm_batched` (B
independent fits on tensors with a leading batch axis): each step takes
only the members still running, so a finished member is left as it is,
as the done flag of the JAX package's vmapped loop leaves it.

:func:`varpro_lm_checkpointed` runs the loop in chunks, resuming from
the solver state a checkpoint file holds, and
:func:`optdmd_from_svd_batched` fits the members of an ensemble in one
batched loop.

On a mesh (:func:`varpro_lm_batched`'s ``mesh``), the members split
over the ``data`` axis: each rank solves its own share with no
collective, and one ``all_gather`` over ``data`` returns the whole
batch to every rank, as every JAX process sees the ``shard_map``
result.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from dmd_era5_tpu_torch.parallel.collectives import all_gather_packed
from dmd_era5_tpu_torch.parallel.mesh import AXIS_DATA
from dmd_era5_tpu_torch.utils.linalg import complex_lstsq, eig_sorted, spd_solve
from dmd_era5_tpu_torch.utils.tensors import as_tensor

__all__ = [
    "OptDMDResult",
    "BatchedOptDMDResult",
    "fit_optdmd",
    "optdmd_from_svd",
    "optdmd_from_svd_batched",
    "optdmd_reconstruct",
    "varpro_lm",
    "varpro_lm_batched",
    "varpro_lm_checkpointed",
]

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
    """Phi(alpha) = exp(t outer alpha), shape (..., T, r)."""
    return torch.exp(t.to(alpha.dtype)[..., :, None] * alpha[..., None, :])


def _solve_b(phi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """B = argmin ||Phi B - H||, (r, k), on a column-equilibrated basis.

    With D = diag(1/||phi_j||), solve (Phi D) Y = H and return B = D Y:
    the same B, but the normal matrix has a unit diagonal, so strongly
    damped columns do not drive the f32 Gram singular.  B does not
    depend on D, so D carries no derivative.  A 1e-7 ridge on the unit
    diagonal keeps fully underflowed columns solvable.
    """
    scale = (1.0 / torch.clamp(torch.linalg.vector_norm(phi, dim=-2), min=1e-30)).detach()
    y = complex_lstsq(phi * scale[..., None, :], h, _RIDGE)
    return y * scale[..., :, None]


def _unpack(theta: torch.Tensor) -> torch.Tensor:
    r = theta.shape[-1] // 2
    return torch.complex(theta[..., :r], theta[..., r:])


def _residual(theta: torch.Tensor, h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The variable-projection residual H - Phi B(alpha), real and
    imaginary parts stacked: (..., 2Tk) for theta (..., 2r)."""
    phi = _phi_matrix(_unpack(theta), t)
    res = h - phi @ _solve_b(phi, h)
    return torch.cat([res.real.flatten(-2), res.imag.flatten(-2)], dim=-1)


def _func():
    """``torch.func``, with forward-AD's decomposition table loaded once
    outside the caller's warning filters (loading it emits a
    DeprecationWarning from inside torch)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import torch._decomp.decompositions_for_jvp  # noqa: F401
    return torch.func


def _jacobian(theta: torch.Tensor, h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Each member's Jacobian of :func:`_residual`, (B, 2Tk, 2r): one
    forward-mode product per parameter, the same tangent e_j for every
    member at once (members are independent, so column j of each
    member's Jacobian comes out of one batched product)."""
    func = _func()
    n_batch, n_par = theta.shape
    basis = torch.eye(n_par, dtype=theta.dtype, device=theta.device)[:, None, :]
    basis = basis.expand(n_par, n_batch, n_par)

    def column(tangent):
        return func.jvp(lambda th: _residual(th, h, t), (theta,), (tangent,))[1]

    return func.vmap(column)(basis).permute(1, 2, 0)


def _res_norm(theta: torch.Tensor, h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(_residual(theta, h, t), dim=-1)


def _lm_step(theta, lam, rnorm, h, t, tol):
    """One LM step of the members given (theta (A, 2r), lam (A,) f64,
    rnorm (A,)): each member's damping raised until its step is accepted
    or its lambda passes the cap.  Returns the new theta, lam and rnorm
    and each member's done flag."""
    jac = _jacobian(theta, h, t)  # (A, 2Tk, 2r)
    res = _residual(theta, h, t)
    jtj = jac.mT @ jac
    g = jac.mT @ res[..., None]
    diag = torch.diagonal(jtj, dim1=-2, dim2=-1)
    diag = torch.diag_embed(torch.where(diag <= 0, torch.ones_like(diag), diag))

    lam_try = lam.clone()
    theta_try, r_try = theta.clone(), rnorm.clone()
    accepted = torch.zeros_like(rnorm, dtype=torch.bool)
    trying = torch.ones_like(accepted)
    while True:
        idx = torch.nonzero(trying).flatten()
        if idx.numel() == 0:
            break
        lam_i = lam_try[idx]
        a = jtj[idx] + lam_i.to(jtj.dtype)[:, None, None] * diag[idx]
        cand = theta[idx] - spd_solve(a, g[idx])[..., 0]
        r = _res_norm(cand, h[idx], t[idx])
        ok = r < rnorm[idx]
        theta_try[idx], r_try[idx], accepted[idx] = cand, r, ok
        lam_i = torch.where(ok, lam_i, lam_i * _LAMBDA_UP)
        lam_try[idx] = lam_i
        trying[idx] = ~ok & (lam_i <= _LAMBDA_CAP)

    rnorm_new = torch.where(accepted, r_try, rnorm)
    improved = (rnorm - rnorm_new) > tol * torch.clamp(rnorm, min=1e-30)
    theta_new = torch.where(accepted[:, None], theta_try, theta)
    lam_new = torch.where(accepted, lam_try / _LAMBDA_DOWN, lam_try)
    return theta_new, lam_new, rnorm_new, ~improved | ~accepted


def _varpro(h: torch.Tensor, t: torch.Tensor, alpha0: torch.Tensor, max_iter: int, tol: float,
            state=None):
    """The LM fits of B members: h (B, T, k) complex64, t (B, T) f32,
    alpha0 (B, r) complex64, on one device.  Every step takes the members
    still running (not done and under ``max_iter``), so a member that
    has finished is left as it is while its batch-mates go on, as the
    done flag of the JAX package's vmapped loop leaves it.  ``state``:
    the solver state to resume from, (theta (B, 2r) f32, lambda (B,)
    f64, residual norm (B,) f32, steps taken (B,) int32, done (B,)
    bool); a member resumed at step 0 takes its residual norm afresh, as
    the JAX loop does.  Returns tensors alpha (B, r), B (B, r, k),
    rel_residual (B,), n_iters (B,) and the state reached."""
    if state is None:
        n_batch = h.shape[0]
        theta = torch.cat([alpha0.real, alpha0.imag], dim=-1)
        lam = torch.full((n_batch,), _LAMBDA0, dtype=torch.float64, device=h.device)
        n_iters = torch.zeros(n_batch, dtype=torch.int32, device=h.device)
        done = torch.zeros(n_batch, dtype=torch.bool, device=h.device)
        rnorm = _res_norm(theta, h, t)
    else:
        theta, lam, rnorm, n_iters, done = (a.clone() for a in state)
        rnorm = torch.where(n_iters == 0, _res_norm(theta, h, t), rnorm)
    while True:
        act = torch.nonzero(~done & (n_iters < max_iter)).flatten()
        if act.numel() == 0:
            break
        theta[act], lam[act], rnorm[act], done[act] = _lm_step(
            theta[act], lam[act], rnorm[act], h[act], t[act], tol
        )
        n_iters[act] += 1
    alpha = _unpack(theta)
    b = _solve_b(_phi_matrix(alpha, t), h)
    rel = rnorm / torch.linalg.vector_norm(h, dim=(-2, -1))
    return alpha, b, rel, n_iters, (theta, lam, rnorm, n_iters, done)


# dtypes of the solver state's leaves (theta, lambda, residual norm, steps,
# done); lambda is stored in f32, as the JAX package's state holds it
_STATE_DTYPES = (torch.float32, torch.float64, torch.float32, torch.int32, torch.bool)
_STATE_NUMPY = ("float32", "float32", "float32", "int32", "bool")


def varpro_lm(
    h,
    t,
    alpha0,
    max_iter: int = 50,
    tol: float = 1e-7,
    state0=None,
    return_state: bool = False,
):
    """Levenberg-Marquardt over alpha with B eliminated by projection.

    h: (T, k) complex data; t: (T,) sample times; alpha0: (r,) complex
    initial eigenvalues; tensors (on one device) or host arrays.
    ``state0``: a state to resume from, (theta (2r,), lambda, residual
    norm, steps taken, done), as a previous call's ``return_state=True``
    gives it (tensors) or a checkpoint holds it (arrays); the loop then
    runs on to ``max_iter`` steps in all.  Returns (alpha, B,
    rel_residual, n_iters[, state]), tensors on h's device but n_iters
    an int.
    """
    h = as_tensor(h, torch.complex64)
    t = as_tensor(t, torch.float32, h.device)
    alpha0 = as_tensor(alpha0, torch.complex64, h.device)
    state = None
    if state0 is not None:
        state = tuple(as_tensor(a, dtype, h.device).reshape(1, -1) if i == 0
                      else as_tensor(a, dtype, h.device).reshape(1)
                      for i, (a, dtype) in enumerate(zip(state0, _STATE_DTYPES)))
    alpha, b, rel, n_iters, state = _varpro(h[None], t[None], alpha0[None], max_iter, tol, state)
    out = (alpha[0], b[0], rel[0], int(n_iters[0]))
    return out + (tuple(a[0] for a in state),) if return_state else out


def varpro_lm_checkpointed(
    h,
    t,
    alpha0,
    checkpoint_path,
    max_iter: int = 50,
    chunk_iters: int = 10,
    tol: float = 1e-7,
):
    """:func:`varpro_lm` in chunks of ``chunk_iters`` steps, the solver
    state written to an HDF5 checkpoint after each (``utils/checkpoint.py``:
    the JAX package's layout, so a checkpoint that either package writes
    resumes in the other).  A solve killed midway resumes from the last
    chunk written at ``checkpoint_path``.  Counterpart of
    ``dmd_era5_tpu/models/optdmd.py:409``.
    """
    from pathlib import Path

    from dmd_era5_tpu_torch.utils.checkpoint import load_pytree, save_pytree

    state = None
    start_iter = 0
    path = Path(checkpoint_path)
    if path.exists():
        state, _ = load_pytree(path)
        start_iter = int(state[3])

    it = start_iter
    result = None
    while it < max_iter:
        cap = min(it + chunk_iters, max_iter)
        *result, state = varpro_lm(h, t, alpha0, max_iter=cap, tol=tol, state0=state,
                                   return_state=True)
        leaves = tuple(a.cpu().numpy().astype(dt) for a, dt in zip(state, _STATE_NUMPY))
        save_pytree(path, leaves, metadata={"iteration": result[3]})
        it = result[3]
        if bool(state[4]) or it >= max_iter:
            break
        if it == start_iter:  # no progress (converged at a chunk's edge)
            break
        start_iter = it
    if result is None:
        result = varpro_lm(h, t, alpha0, max_iter=max_iter, tol=tol, state0=state)
    return tuple(result)


def varpro_lm_batched(
    h,
    t,
    alpha0,
    max_iter: int = 50,
    tol: float = 1e-7,
    mesh=None,
):
    """Batched LM over independent members, each one :func:`varpro_lm`.

    h: (B, T, k) complex; t: (T,) sample times shared by the members, or
    (B, T), one row per member (the BOP-DMD case: every trial fits its
    own snapshot subset); alpha0: (B, r).  Tensors or arrays; the fits
    run on h's device (the host for an array), or on a mesh on its
    device.

    ``mesh``: with a ``data`` axis of more than one rank the members are
    padded to a multiple of it with copies of member 0 (a per-member t
    too; a shared t is not) and split over it in blocks; each rank solves
    its block (ranks of one ``data`` index solve the same members), with
    no collective, and one ``all_gather`` over ``data`` of the packed
    results returns every member to every rank, the padding dropped
    (``dmd_era5_tpu/models/optdmd.py:367-395``).  A diverged member's
    non-finite values cross the gather as they are.

    Returns (alpha (B, r) complex64, B (B, r, k) complex64, rel_residual
    (B,) float32, n_iters (B,) int32) as host numpy arrays, alike on
    every rank.
    """
    device = None if mesh is None else mesh.device
    h = as_tensor(h, torch.complex64, device)
    t = as_tensor(t, torch.float32, h.device)
    alpha0 = as_tensor(alpha0, torch.complex64, h.device)
    if t.ndim == 1:
        t = t.expand(h.shape[0], -1)
    n_data = 1 if mesh is None else mesh.shape[AXIS_DATA]
    if n_data == 1:
        return tuple(a.cpu().numpy() for a in _varpro(h, t, alpha0, max_iter, tol)[:4])

    n_batch = h.shape[0]
    per = -(-n_batch // n_data)
    pad = per * n_data - n_batch
    h, t, alpha0 = (torch.cat([a, a[:1].expand(pad, *a.shape[1:])]) if pad else a
                    for a in (h, t, alpha0))
    mine = slice(mesh.coords[AXIS_DATA] * per, (mesh.coords[AXIS_DATA] + 1) * per)
    alpha, b, rel, n_iters, _ = _varpro(h[mine], t[mine], alpha0[mine], max_iter, tol)
    gathered = all_gather_packed([alpha, b, rel, n_iters], AXIS_DATA, mesh)
    alpha, b, rel, n_iters = (a[:n_batch] for a in gathered)
    return tuple(a.cpu().numpy() for a in (alpha, b, rel, n_iters))


def _eig_init(z: torch.Tensor, t: torch.Tensor, rank: int) -> torch.Tensor:
    """Exact-DMD eigenvalue init on the projected data z (k, T)."""
    return _eig_init_batched(z[None], t, rank)[0]


def _eig_init_batched(z: torch.Tensor, t, rank: int) -> torch.Tensor:
    """Exact-DMD eigenvalue init on projected data z (B, k, T): (B, r)
    complex64, each member's eigenvalues by descending modulus."""
    dt = float(t[1] - t[0])
    z1, z2 = z[..., :-1], z[..., 1:]
    u, s, vt = torch.linalg.svd(z1.float(), full_matrices=False)
    u, s, vt = u[..., :rank], s[..., :rank], vt[..., :rank, :]
    atilde = (u.mT @ z2) @ (vt.mT / s[..., None, :])
    eigvals, _ = eig_sorted(atilde)
    return torch.log(eigvals) / dt


def _lift_modes(u: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Modes U C (S, r) complex64 from the real basis u (S, k) and the
    complex coefficients coef (k, r): one real f32 GEMM against C's
    real and imaginary parts interleaved by column, whose (S, 2r) result
    is the complex (S, r) array itself (no complex copy of u is made)."""
    c = torch.view_as_real(coef.to(device=u.device, dtype=torch.complex64))  # (k, r, 2)
    out = u.float() @ c.reshape(c.shape[0], -1)
    return torch.view_as_complex(out.view(out.shape[0], -1, 2))


def optdmd_from_svd(
    u: torch.Tensor,
    s: torch.Tensor,
    v: torch.Tensor,
    t: torch.Tensor,
    rank: int | None = None,
    alpha0=None,
    max_iter: int = 50,
    tol: float = 1e-7,
) -> OptDMDResult:
    """Optimized DMD from the truncated SVD of the snapshot matrix.

    u (S, k), s (k,), v (k, T) with components as rows, t (T,) sample
    times; rank r <= k eigenvalues (default k); alpha0 (r,) the initial
    eigenvalues (default: exact DMD's on the projected data).  The fit
    sees only H = (diag(s) V)^T; the one S-sized product is the mode
    lift.  ``max_iter = 0`` is exact DMD: alpha0 and its B.
    """
    rank = rank or s.shape[0]
    t = as_tensor(t, torch.float32, u.device)
    z_proj = s[:, None] * v  # (k, T) projected snapshots
    alpha0 = _eig_init(z_proj, t, rank) if alpha0 is None \
        else as_tensor(alpha0, torch.complex64, u.device)
    alpha, b, rel_res, n_iters = varpro_lm(
        z_proj.T.to(torch.complex64), t, alpha0, max_iter=max_iter, tol=tol
    )
    # amplitudes: ||U B^T e_j|| = ||B[j, :]|| since U is orthonormal
    amps = torch.linalg.vector_norm(b, dim=1)
    coef = (b / torch.where(amps == 0, torch.ones_like(amps), amps)[:, None]).T
    return OptDMDResult(alpha, _lift_modes(u, coef), amps, b, rel_res, n_iters)


class BatchedOptDMDResult(NamedTuple):
    """Per-member optimized-DMD fits from one batched solve, tensors on
    U's device: alpha (B, r) complex; modes (B, S, r) complex unit
    columns; amplitudes (B, r) real; b_proj (B, r, k) complex; residual
    (B,); n_iters (B,)."""

    alpha: torch.Tensor
    modes: torch.Tensor
    amplitudes: torch.Tensor
    b_proj: torch.Tensor
    residual: torch.Tensor
    n_iters: torch.Tensor


def optdmd_from_svd_batched(
    u: torch.Tensor,
    s: torch.Tensor,
    v: torch.Tensor,
    t,
    rank: int | None = None,
    alpha0=None,
    max_iter: int = 50,
    tol: float = 1e-7,
) -> BatchedOptDMDResult:
    """Optimized DMD of B members from their truncated SVDs, on U's
    device: u (B, S, k), s (B, k), v (B, k, T) (the ensemble's
    ``FitState``), t (T,) shared sample times.  One batched LM
    (:func:`varpro_lm_batched`'s loop), then each member's modes lifted
    by one real GEMM.  Counterpart of ``dmd_era5_tpu/models/optdmd.py:528``.
    """
    rank = rank or s.shape[-1]
    t = as_tensor(t, torch.float32, u.device)
    z_proj = s[..., None] * v  # (B, k, T)
    alpha0 = _eig_init_batched(z_proj, t, rank) if alpha0 is None \
        else as_tensor(alpha0, torch.complex64, u.device)
    h = z_proj.mT.to(torch.complex64)
    alpha, b, rel, n_iters, _ = _varpro(h, t.expand(h.shape[0], -1), alpha0, max_iter, tol)
    amps = torch.linalg.vector_norm(b, dim=2)
    coef = (b / torch.where(amps == 0, torch.ones_like(amps), amps)[..., None]).mT  # (B, k, r)
    modes = torch.empty((u.shape[0], u.shape[1], coef.shape[-1]), dtype=torch.complex64,
                        device=u.device)
    for i in range(u.shape[0]):
        modes[i] = _lift_modes(u[i], coef[i])
    return BatchedOptDMDResult(alpha, modes, amps, b, rel, n_iters)


def fit_optdmd(
    x: torch.Tensor,
    t,
    rank: int,
    max_iter: int = 50,
    tol: float = 1e-7,
) -> OptDMDResult:
    """Optimized DMD of a (S, T) snapshot matrix on its device, through
    its full f32 SVD truncated to ``rank``."""
    u, sv, vt = torch.linalg.svd(x.float(), full_matrices=False)
    return optdmd_from_svd(u[:, :rank], sv[:rank], vt[:rank, :], t, rank=rank,
                           max_iter=max_iter, tol=tol)


def optdmd_reconstruct(result: OptDMDResult, t) -> torch.Tensor:
    """X^(S, T') = modes diag(amplitudes) exp(alpha t), real part."""
    from dmd_era5_tpu_torch.models.forecast import rollout

    return rollout(result, t)
