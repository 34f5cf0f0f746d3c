"""Forecast / reconstruction rollout and the inverse preprocessing.

PyTorch counterpart of ``dmd_era5_tpu/models/forecast.py``:
X^(t) = Phi diag(b) exp(alpha t) as one skinny (S, r) x (r, T') product
on the device of the modes, then undo the standardization and keep the
undelayed block of the delay embedding.
"""

from __future__ import annotations

import torch

from dmd_era5_tpu_torch.models.dmd import DMDResult
from dmd_era5_tpu_torch.models.optdmd import OptDMDResult

__all__ = ["rollout", "forecast_times", "undo_preprocessing"]


def rollout(result: DMDResult | OptDMDResult, t: torch.Tensor) -> torch.Tensor:
    """Evaluate the fitted linear model at times ``t``; real (S, len(t)).

    The small complex dynamics matrix is formed in complex128, as the
    JAX version forms it on the host, and the S-sized contraction
    Re(M D) = M_re D_re - M_im D_im runs as two real f32 GEMMs.
    """
    alpha = result.omega if isinstance(result, DMDResult) else result.alpha
    modes = result.modes
    t64 = t.to(device=modes.device, dtype=torch.float64)
    scale = result.amplitudes.to(torch.complex128)
    dynamics = scale[:, None] * torch.exp(alpha.to(torch.complex128)[:, None] * t64[None, :])
    d_re = dynamics.real.float()
    d_im = dynamics.imag.float()
    return modes.real @ d_re - modes.imag @ d_im


def forecast_times(
    n_history: int, n_future: int, dt: float, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """Times covering the training window plus ``n_future`` extra steps."""
    return torch.arange(n_history + n_future, device=device) * dt


def undo_preprocessing(
    x: torch.Tensor,
    mean: torch.Tensor | None = None,
    std: torch.Tensor | None = None,
    delay: int = 1,
) -> torch.Tensor:
    """Invert standardize + delay-embed on reconstructed snapshots.

    x: (S * delay, T'); mean/std: (S * delay,) per-row statistics tiled
    across the delay blocks.  Returns the last block (delay coordinate
    0, the undelayed rows).
    """
    if std is not None:
        x = x * std[:, None]
    if mean is not None:
        x = x + mean[:, None]
    if delay > 1:
        s = x.shape[0] // delay
        x = x[(delay - 1) * s :, :]
    return x
