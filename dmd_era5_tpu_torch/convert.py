"""State carried across from the JAX package.

Turn the JAX package's outputs, as numpy arrays, into this package's
result types on a chosen device: an SVD artifact written by the JAX
``era5_svd`` stage can feed :func:`models.optdmd.optdmd_from_svd` here,
and the parity tests hand one side's state to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from dmd_era5_tpu_torch.models.bopdmd import BOPDMDResult
from dmd_era5_tpu_torch.models.dmd import DMDResult
from dmd_era5_tpu_torch.models.optdmd import OptDMDResult
from dmd_era5_tpu_torch.ops.svd import SVDResult
from dmd_era5_tpu_torch.pipeline.train_step import FitState

__all__ = [
    "svd_result_from_numpy",
    "fit_state_from_numpy",
    "optdmd_result_from_numpy",
    "dmd_result_from_numpy",
    "bopdmd_result_from_numpy",
]


def _tensor(a, device, dtype) -> torch.Tensor:
    # a copy: arrays from JAX are read-only, which torch will not wrap
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def svd_result_from_numpy(U, s, V, device: torch.device | str = "cpu") -> SVDResult:
    """(U (S, k), s (k,), V (k, T)) -> float32 :class:`SVDResult`."""
    return SVDResult(*(_tensor(a, device, torch.float32) for a in (U, s, V)))


def fit_state_from_numpy(
    u, s, v, a_red, loss, device: torch.device | str = "cpu"
) -> FitState:
    """The unbatched leaves of a JAX ``FitState`` -> float32 :class:`FitState`."""
    return FitState(*(_tensor(a, device, torch.float32) for a in (u, s, v, a_red, loss)))


def optdmd_result_from_numpy(
    alpha, modes, amplitudes, b_proj, residual, n_iters,
    device: torch.device | str = "cpu",
) -> OptDMDResult:
    """A JAX ``OptDMDResult`` -> :class:`OptDMDResult` (complex64 alpha,
    modes and b_proj; float32 amplitudes and residual)."""
    return OptDMDResult(
        _tensor(alpha, device, torch.complex64),
        _tensor(modes, device, torch.complex64),
        _tensor(amplitudes, device, torch.float32),
        _tensor(b_proj, device, torch.complex64),
        _tensor(residual, device, torch.float32),
        int(n_iters),
    )


def dmd_result_from_numpy(
    eigenvalues, omega, modes, amplitudes, dt, device: torch.device | str = "cpu"
) -> DMDResult:
    """A JAX ``DMDResult`` -> :class:`DMDResult` (complex64 eigenvalues,
    omega, modes and amplitudes)."""
    return DMDResult(
        *(_tensor(a, device, torch.complex64) for a in (eigenvalues, omega, modes, amplitudes)),
        float(dt),
    )


def bopdmd_result_from_numpy(
    eigenvalues, eigenvalues_std, modes, modes_std, amplitudes, amplitudes_std, full,
    trial_eigenvalues, n_iters, device: torch.device | str = "cpu",
) -> BOPDMDResult:
    """A JAX ``BOPDMDResult`` -> :class:`BOPDMDResult`; ``full`` is the
    JAX ``OptDMDResult`` (or its six arrays in order)."""
    return BOPDMDResult(
        _tensor(eigenvalues, device, torch.complex64),
        _tensor(eigenvalues_std, device, torch.float32),
        _tensor(modes, device, torch.complex64),
        _tensor(modes_std, device, torch.float32),
        _tensor(amplitudes, device, torch.float32),
        _tensor(amplitudes_std, device, torch.float32),
        optdmd_result_from_numpy(*full, device=device),
        _tensor(trial_eigenvalues, device, torch.complex64),
        _tensor(n_iters, device, torch.int32),
    )
