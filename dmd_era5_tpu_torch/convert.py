"""State carried across from the JAX package.

Turn the JAX package's outputs, as numpy arrays, into this package's
result types on a device: the card unless ``device`` names another (no
card and no ``device`` raises).  An SVD artifact written by the JAX
``era5_svd`` stage can feed :func:`models.optdmd.optdmd_from_svd` here,
and the parity tests hand one side's state to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from dmd_era5_tpu_torch.models.bopdmd import BOPDMDResult
from dmd_era5_tpu_torch.models.dmd import DMDResult
from dmd_era5_tpu_torch.models.dmdc import DMDcResult
from dmd_era5_tpu_torch.models.mrdmd import MrDMDLevel, MrDMDResult
from dmd_era5_tpu_torch.models.optdmd import _STATE_DTYPES, BatchedOptDMDResult, OptDMDResult
from dmd_era5_tpu_torch.ops.svd import SVDResult
from dmd_era5_tpu_torch.pipeline.ensemble import EnsembleFit
from dmd_era5_tpu_torch.pipeline.train_step import FitState
from dmd_era5_tpu_torch.utils.tensors import home_device

__all__ = [
    "svd_result_from_numpy",
    "fit_state_from_numpy",
    "optdmd_result_from_numpy",
    "dmd_result_from_numpy",
    "bopdmd_result_from_numpy",
    "dmdc_result_from_numpy",
    "mrdmd_result_from_numpy",
    "ensemble_fit_from_numpy",
    "lm_state_from_numpy",
]


def _tensor(a, device, dtype) -> torch.Tensor:
    # a copy: arrays from JAX are read-only, which torch will not wrap
    return torch.as_tensor(np.array(a), dtype=dtype, device=home_device(None, device))


def svd_result_from_numpy(U, s, V, device: torch.device | str | None = None) -> SVDResult:
    """(U (S, k), s (k,), V (k, T)) -> float32 :class:`SVDResult`."""
    return SVDResult(*(_tensor(a, device, torch.float32) for a in (U, s, V)))


def fit_state_from_numpy(
    u, s, v, a_red, loss, device: torch.device | str | None = None
) -> FitState:
    """The unbatched leaves of a JAX ``FitState`` -> float32 :class:`FitState`."""
    return FitState(*(_tensor(a, device, torch.float32) for a in (u, s, v, a_red, loss)))


def optdmd_result_from_numpy(
    alpha, modes, amplitudes, b_proj, residual, n_iters,
    device: torch.device | str | None = None,
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
    eigenvalues, omega, modes, amplitudes, dt, device: torch.device | str | None = None
) -> DMDResult:
    """A JAX ``DMDResult`` -> :class:`DMDResult` (complex64 eigenvalues,
    omega, modes and amplitudes)."""
    return DMDResult(
        *(_tensor(a, device, torch.complex64) for a in (eigenvalues, omega, modes, amplitudes)),
        float(dt),
    )


def bopdmd_result_from_numpy(
    eigenvalues, eigenvalues_std, modes, modes_std, amplitudes, amplitudes_std, full,
    trial_eigenvalues, n_iters, device: torch.device | str | None = None,
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


def dmdc_result_from_numpy(
    eigenvalues, omega, modes, a_red, b_red, u_hat, dt, residual=float("nan"),
    device: torch.device | str | None = None,
) -> DMDcResult:
    """A JAX ``DMDcResult`` -> :class:`DMDcResult` (complex64 eigenvalues,
    omega and modes; float32 a_red, b_red and u_hat)."""
    c64, f32 = torch.complex64, torch.float32
    return DMDcResult(
        *(_tensor(a, device, dt_) for a, dt_ in ((eigenvalues, c64), (omega, c64), (modes, c64),
                                                  (a_red, f32), (b_red, f32), (u_hat, f32))),
        float(dt), float(residual),
    )


def mrdmd_result_from_numpy(
    levels, residual, dt, t_used, residual_fro=None, x_fro=None,
    device: torch.device | str | None = None,
) -> MrDMDResult:
    """A JAX ``MrDMDResult`` -> :class:`MrDMDResult`: each level's modes
    and the residual as tensors (complex64, float32), its spectra,
    amplitudes, masks and mode maps host arrays as they are.  ``levels``
    holds JAX ``MrDMDLevel``s (or their fields in order)."""
    device = home_device(None, device)  # the card, even with no modes to place
    out = []
    for lv in levels:
        lv = MrDMDLevel(*lv)
        modes = None if lv.modes is None else _tensor(lv.modes, device, torch.complex64)
        out.append(lv._replace(modes=modes))
    res = None if residual is None else _tensor(residual, device, torch.float32)
    return MrDMDResult(out, res, float(dt), int(t_used), residual_fro, x_fro)


def ensemble_fit_from_numpy(labels, state, dmd=None,
                            device: torch.device | str | None = None) -> EnsembleFit:
    """A JAX ``EnsembleFit`` -> :class:`EnsembleFit`: ``state`` the
    batched FitState's five leaves, ``dmd`` the six of a
    ``BatchedOptDMDResult`` or None."""
    fit = FitState(*(_tensor(a, device, torch.float32) for a in state))
    if dmd is not None:
        alpha, modes, amplitudes, b_proj, residual, n_iters = dmd
        dmd = BatchedOptDMDResult(
            _tensor(alpha, device, torch.complex64), _tensor(modes, device, torch.complex64),
            _tensor(amplitudes, device, torch.float32), _tensor(b_proj, device, torch.complex64),
            _tensor(residual, device, torch.float32), _tensor(n_iters, device, torch.int32),
        )
    return EnsembleFit([(str(v), int(lev)) for v, lev in labels], fit, dmd)


def lm_state_from_numpy(theta, lam, rnorm, n_iters, done,
                        device: torch.device | str | None = None) -> tuple:
    """The LM solver state of a JAX checkpoint tree (theta, lambda,
    residual norm, steps, done) -> the tensors ``varpro_lm(state0=...)``
    takes and ``return_state=True`` gives."""
    return tuple(_tensor(a, device, dt_)
                 for a, dt_ in zip((theta, lam, rnorm, n_iters, done), _STATE_DTYPES))
