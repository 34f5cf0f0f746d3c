"""DMD with control (DMDc): dynamics with a measured forcing.

PyTorch counterpart of ``dmd_era5_tpu/models/dmdc.py`` (Proctor, Brunton
& Kutz, SIAM J. Appl. Dyn. Syst., 2016): fit

    x_{k+1} ~ A x_k + B u_k

from snapshots X (S, T) and inputs U (q, T-1).  Both truncated SVDs, of
the stacked input [X1; gamma U] and of the output X2, go through the
Gram route (``ops.svd.exact_truncated_svd_gram`` at ``"highest"``: on a
card tensor the Gram kernel K4, then K1's Rayleigh-Ritz pass); every
other S-sized contraction is a full-f32 ``torch.matmul``, the reduced
operators are r x r and r x q, and the eigendecomposition runs on the
device.  The modes stay on the device.

On a mesh the two Gram-route SVDs run over its ``space`` axis: each rank
takes its row block of [X1; gamma U] and of X2 (``parallel.shard_rows``,
zero rows padding a count that does not divide the axis: they add
nothing to a Gram), the T x T Grams and the Rayleigh-Ritz sums are
psum'd, and Ut and Uh are gathered back whole
(``parallel.assemble_rows``, the padding cut).  The rest of the algebra
runs whole on every rank, as on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmd_era5_tpu_torch.models.optdmd import _lift_modes
from dmd_era5_tpu_torch.ops.svd import exact_truncated_svd_gram
from dmd_era5_tpu_torch.parallel.mesh import AXIS_SPACE
from dmd_era5_tpu_torch.parallel.sharding import assemble_rows, shard_rows
from dmd_era5_tpu_torch.utils.linalg import eig_sorted
from dmd_era5_tpu_torch.utils.tensors import as_tensor, home_device

__all__ = ["DMDcResult", "fit_dmdc", "dmdc_from_svd", "dmdc_rollout"]


class DMDcResult(NamedTuple):
    """eigenvalues (r,) complex discrete-time eigenvalues of the UNFORCED
    reduced operator; omega (r,) log(eigenvalues)/dt; modes (S, r)
    complex unit columns; a_red (r, r) = U_hat^T A U_hat; b_red (r, q) =
    U_hat^T B; u_hat (S, r) the output POD basis (the lift and restrict
    map of :func:`dmdc_rollout`); dt; residual the one-step relative
    residual of the forced model in the reduced space.  Tensors on the
    fit's device."""

    eigenvalues: torch.Tensor
    omega: torch.Tensor
    modes: torch.Tensor
    a_red: torch.Tensor
    b_red: torch.Tensor
    u_hat: torch.Tensor
    dt: float
    residual: float = float("nan")


def _unit_columns(m: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(m, dim=0)
    return m / torch.where(norms == 0, torch.ones_like(norms), norms)[None, :]


def _gram_svd(a: torch.Tensor, rank: int, mesh):
    """The Gram-route SVD of a at ``"highest"``: on one device, or over the
    mesh's ``space`` axis on the rank's row block with U gathered whole
    to a's device."""
    if mesh is None:
        return exact_truncated_svd_gram(a, rank, gram_precision="highest")
    block, rows = shard_rows(a, mesh, AXIS_SPACE)
    u, s, vt = exact_truncated_svd_gram(block, rank, gram_precision="highest", mesh=mesh,
                                        axis_name=AXIS_SPACE)
    del block
    u = torch.from_numpy(assemble_rows(u, mesh, AXIS_SPACE, rows=rows)).to(a.device)
    return u, s.to(a.device), vt.to(a.device)


def fit_dmdc(
    x,
    u_ctrl,
    rank: int,
    rank_omega: int | None = None,
    dt: float = 1.0,
    mesh=None,
    device: torch.device | str | None = None,
) -> DMDcResult:
    """Fit x_{k+1} ~ A x_k + B u_k from snapshots and measured inputs.

    x (S, T) snapshots; u_ctrl (q, T-1) inputs, u_k acting on the step
    x_k -> x_{k+1}; rank r of the output basis; rank_omega p of the
    stacked input SVD (default r + q).  ``device``: where the fit runs,
    by default where x lies (the card for a host array); on a ``mesh``
    its device.  ``mesh``: the two SVDs over its ``space`` axis (module
    docstring), x whole on every rank.

    The control block is row-balanced to the state block's RMS before
    stacking (gamma), so state magnitudes that dwarf the controls do not
    push the control directions under the conditioning cutoff; the fit
    estimates [A, B/gamma] and B_red is scaled back by gamma.  With
    Omega = [X1; gamma U] ~ Ut St Vt^T split into Ut = [Ut1; Ut2] and
    X2 ~ Uh Sh Vh^T, K = X2 Vt St^-1 (directions under 1e-3 St[0]
    dropped), A_red = Uh^T K Ut1^T Uh, B_red = gamma Uh^T K Ut2^T, and
    the exact modes of A are K Ut1^T Uh W.
    """
    device = home_device(x, device) if mesh is None else mesh.device
    x = as_tensor(x, torch.float32, device)
    u_ctrl = as_tensor(u_ctrl, torch.float32, device)
    s_rows, t_total = x.shape
    q = u_ctrl.shape[0]
    if u_ctrl.shape[1] != t_total - 1:
        raise ValueError(
            f"u_ctrl must be (q, T-1) = (q, {t_total - 1}); got {tuple(u_ctrl.shape)}"
        )
    p = rank + q if rank_omega is None else rank_omega
    if p < 1:
        raise ValueError(f"rank_omega must be >= 1; got {rank_omega}")

    x1, x2 = x[:, :-1], x[:, 1:]
    x1_rms = torch.sqrt(torch.mean(torch.square(x1)))
    u_rms = torch.sqrt(torch.mean(torch.square(u_ctrl)))
    gamma = torch.where((u_rms > 0) & (x1_rms > 0), x1_rms / torch.clamp(u_rms, min=1e-30),
                        torch.ones_like(u_rms))
    omega_mat = torch.cat([x1, gamma * u_ctrl], dim=0)  # (S + q, T - 1), row-major
    ut, st, vtt = _gram_svd(omega_mat, p, mesh)
    del omega_mat
    uh, _, _ = _gram_svd(x2.contiguous(), rank, mesh)
    ut1, ut2 = ut[:s_rows], ut[s_rows:]

    st_inv = torch.where(st > 1e-3 * st[0], 1.0 / torch.clamp(st, min=1e-30),
                         torch.zeros_like(st))
    k_fac = x2 @ (vtt.T * st_inv[None, :])  # (S, p)
    uh_t_k = uh.T @ k_fac  # (r, p)
    ut1_t_uh = ut1.T @ uh  # (p, r)
    a_red = uh_t_k @ ut1_t_uh
    b_red = gamma * (uh_t_k @ ut2.T)  # in the caller's units of u

    eigvals, w = eig_sorted(a_red)
    phi = _unit_columns(_lift_modes(k_fac @ ut1_t_uh, w))

    # one-step relative residual of A z + B u in the reduced space
    zr1, zr2 = uh.T @ x1, uh.T @ x2
    pred = a_red @ zr1 + b_red @ u_ctrl
    residual = float(torch.linalg.vector_norm(zr2 - pred)
                     / torch.clamp(torch.linalg.vector_norm(zr2), min=1e-30))
    omega = (torch.log(eigvals.to(torch.complex128)) / dt).to(torch.complex64)
    return DMDcResult(eigvals, omega, phi, a_red, b_red, uh, dt, residual)


def dmdc_from_svd(
    u,
    s,
    v,
    u_ctrl,
    rank: int,
    rank_omega: int | None = None,
    dt: float = 1.0,
    mesh=None,
) -> DMDcResult:
    """DMDc from the truncated SVD factors of the snapshot matrix, on U's
    device (the stage's entry).

    The forced dynamics are fit on the projected snapshots Z = S V^T (k,
    T), so both factorizations are k-sized, and the modes and the lift
    basis return to full space with one real GEMM each against U.
    u (S, k), s (k,), v (k, T); u_ctrl (q, T-1); rank <= k.  ``mesh``:
    the k-sized fit's two SVDs over its ``space`` axis (:func:`fit_dmdc`);
    the lift by U, whole on every rank, stays on U's device.
    """
    device = home_device(u)
    u = as_tensor(u, torch.float32, device)
    z = as_tensor(s, torch.float32, device)[:, None] * as_tensor(v, torch.float32, device)
    res = fit_dmdc(z, u_ctrl, rank=rank, rank_omega=rank_omega, dt=dt, mesh=mesh)
    modes = _unit_columns(_lift_modes(u, res.modes))
    return res._replace(modes=modes, u_hat=u @ res.u_hat.to(device))  # orthonormal, since U is


def dmdc_rollout(result: DMDcResult, x0, u_ctrl) -> torch.Tensor:
    """Forced prediction x_{k+1} = A x_k + B u_k from x0 (S,) under inputs
    u_ctrl (q, n_steps): (S, n_steps + 1), x0 first, on the fit's device.
    The recursion runs in the reduced space; the lift is one GEMM."""
    device = result.u_hat.device
    x0 = as_tensor(x0, torch.float32, device)
    u_ctrl = as_tensor(u_ctrl, torch.float32, device)
    z = result.u_hat.T @ x0
    zs = [z]
    forced = result.b_red @ u_ctrl  # (r, n_steps)
    for k in range(u_ctrl.shape[1]):
        z = result.a_red @ z + forced[:, k]
        zs.append(z)
    return result.u_hat @ torch.stack(zs, dim=1)
