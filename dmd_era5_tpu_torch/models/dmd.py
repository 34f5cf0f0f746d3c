"""Exact (projected) Dynamic Mode Decomposition from truncated SVD factors.

PyTorch counterpart of ``dmd_era5_tpu/models/dmd.py``.
The snapshot matrix is (space, time) with uniform step ``dt``; the only
S-sized products are skinny GEMMs, and the r x r eigenproblem runs on the
device with the factors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmd_era5_tpu_torch.utils.linalg import eig_sorted

__all__ = ["DMDResult", "dmd_from_svd", "exact_dmd", "reconstruct"]


class DMDResult(NamedTuple):
    """eigenvalues (r,) discrete-time; omega (r,) continuous-time
    log(lambda)/dt; modes (S, r) unit-normalized exact modes; amplitudes
    (r,) complex, fit to the first snapshot; dt the sampling interval."""

    eigenvalues: torch.Tensor
    omega: torch.Tensor
    modes: torch.Tensor
    amplitudes: torch.Tensor
    dt: float


def dmd_from_svd(
    x2: torch.Tensor,
    u: torch.Tensor,
    s: torch.Tensor,
    v: torch.Tensor,
    dt: float = 1.0,
) -> DMDResult:
    """Exact DMD given the truncated SVD (u, s, v) of X1 = X[:, :-1].

    x2 (S, T-1) are the shifted snapshots X[:, 1:]; v is (r, T-1) with
    components as rows.  A~ = U^T X2 V S^-1, exact modes
    Phi = X2 V S^-1 W (unit columns), amplitudes from the first snapshot.
    """
    vs = v.T / s[None, :]  # (T-1, r)
    atilde = (u.T @ x2) @ vs
    eigvals, w = eig_sorted(atilde)
    m = x2 @ vs  # (S, r) real
    phi = torch.complex(m @ w.real, m @ w.imag)
    norms = torch.linalg.vector_norm(phi, dim=0)
    phi = phi / torch.where(norms == 0, torch.ones_like(norms), norms)[None, :]
    x0 = u @ (s * v[:, 0])
    b = torch.linalg.lstsq(phi, x0.to(torch.complex64)[:, None]).solution[:, 0]
    omega = torch.log(eigvals) / dt
    return DMDResult(eigvals, omega, phi, b, dt)


def exact_dmd(x: torch.Tensor, rank: int, dt: float = 1.0) -> DMDResult:
    """Exact DMD of a (S, T) snapshot matrix at ``rank``, on its device,
    through the full SVD of X1 = X[:, :-1] truncated to ``rank``."""
    u, s, vt = torch.linalg.svd(x[:, :-1], full_matrices=False)
    return dmd_from_svd(x[:, 1:], u[:, :rank], s[:rank], vt[:rank, :], dt=dt)


def reconstruct(result: DMDResult, n_steps: int) -> torch.Tensor:
    """Snapshots X^(t_i) = Phi diag(b) exp(omega t_i), t_i = i * dt, real
    part, (S, n_steps)."""
    from dmd_era5_tpu_torch.models.forecast import rollout

    return rollout(result, torch.arange(n_steps, dtype=torch.float64) * result.dt)
