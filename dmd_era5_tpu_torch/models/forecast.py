"""Forecast / reconstruction rollout and the inverse preprocessing.

PyTorch counterpart of ``dmd_era5_tpu/models/forecast.py``:
X^(t) = Phi diag(b) exp(alpha t) as one skinny (S, r) x (r, T') product
on the device of the modes, then undo the standardization and keep the
undelayed block of the delay embedding.  :func:`iter_forecast_blocks`
and :func:`streamed_forecast_scores` do the same in row blocks of the
undelayed rows only, so no (S*d, T') array is formed.
"""

from __future__ import annotations

import torch

from dmd_era5_tpu_torch.models.dmd import DMDResult
from dmd_era5_tpu_torch.models.optdmd import OptDMDResult
from dmd_era5_tpu_torch.models.verification import ScoreAccumulator, _space_weights
from dmd_era5_tpu_torch.utils.tensors import as_tensor, home_device

__all__ = [
    "rollout",
    "forecast_times",
    "undo_preprocessing",
    "iter_forecast_blocks",
    "streamed_forecast_scores",
]


def _extract_model(result: DMDResult | OptDMDResult):
    """(alpha, amplitudes, modes) of either result type."""
    alpha = result.omega if isinstance(result, DMDResult) else result.alpha
    return alpha, result.amplitudes, result.modes


def _dynamics(result, t) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(modes, Re D, Im D): D = diag(b) exp(alpha t) (r, T'), formed in
    complex128 (as the JAX package forms it on the host) and rounded to
    f32 on the modes' device."""
    alpha, scale, modes = _extract_model(result)
    t64 = as_tensor(t, torch.float64, modes.device)
    alpha = as_tensor(alpha, torch.complex128, modes.device)
    dynamics = as_tensor(scale, torch.complex128, modes.device)[:, None] * torch.exp(
        alpha[:, None] * t64[None, :]
    )
    return modes, dynamics.real.float(), dynamics.imag.float()


def rollout(result: DMDResult | OptDMDResult, t) -> torch.Tensor:
    """Evaluate the fitted linear model at times ``t``; real (S, len(t)).

    The S-sized contraction Re(M D) = M_re D_re - M_im D_im runs as two
    real f32 GEMMs on the modes' device.
    """
    modes, d_re, d_im = _dynamics(result, t)
    return modes.real @ d_re - modes.imag @ d_im


def forecast_times(
    n_history: int, n_future: int, dt: float, device: torch.device | str | None = None
) -> torch.Tensor:
    """Times covering the training window plus ``n_future`` extra steps,
    on the card unless ``device`` names another (no card and no
    ``device`` raises)."""
    return torch.arange(n_history + n_future, device=home_device(None, device)) * dt


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


def iter_forecast_blocks(
    result: DMDResult | OptDMDResult,
    t,
    mean=None,
    std=None,
    delay: int = 1,
    block_rows: int | None = None,
):
    """Yield ``(s0, fields_blk)`` of the physical-unit forecast field in
    row blocks, each an f32 tensor on the modes' device.

    Equal to ``undo_preprocessing(rollout(result, t), mean, std, delay)``
    without forming it: only rows of the delay-0 block (the undelayed
    rows) go through the rollout GEMM pair, one block at a time, and
    the inverse standardization applies per block.  ``mean`` / ``std``
    (S*d,) may be host arrays: their delay-0 rows are moved once.
    Default ``block_rows``: max(4096, 2^26 // len(t)), ~256 MB of f32 a
    block.
    """
    modes, d_re, d_im = _dynamics(result, t)
    s_out = modes.shape[0] // delay
    offset = (delay - 1) * s_out
    rows = slice(offset, offset + s_out)
    mean = None if mean is None else as_tensor(mean[rows], torch.float32, modes.device)
    std = None if std is None else as_tensor(std[rows], torch.float32, modes.device)
    if block_rows is None:
        block_rows = max(4096, (1 << 26) // max(d_re.shape[1], 1))
    for s0 in range(0, s_out, block_rows):
        s1 = min(s0 + block_rows, s_out)
        m_blk = modes[offset + s0 : offset + s1]
        blk = m_blk.real @ d_re - m_blk.imag @ d_im
        if std is not None:
            blk.mul_(std[s0:s1, None])
        if mean is not None:
            blk.add_(mean[s0:s1, None])
        yield s0, blk


def streamed_forecast_scores(
    result: DMDResult | OptDMDResult,
    t_leads,
    truth,
    latitudes=None,
    mean=None,
    std=None,
    delay: int = 1,
    climatology=None,
    block_rows: int | None = None,
) -> dict:
    """Holdout skill scores {'rmse', 'acc', 'bias'} (host numpy f32), with
    O(block) residency: the model rolled out at the lead times only, the
    forecast blocks of :func:`iter_forecast_blocks` scored as they come
    against the rows of ``truth`` (S, L) (and ``climatology``) moved
    beside them, in the latitude-weighted float64 sums of
    :class:`~dmd_era5_tpu_torch.models.verification.ScoreAccumulator`.
    """
    device = result.modes.device
    s_out = truth.shape[0]
    w = None if latitudes is None else _space_weights(latitudes, s_out, device)
    acc = ScoreAccumulator()
    for s0, blk in iter_forecast_blocks(result, t_leads, mean, std, delay, block_rows):
        s1 = s0 + blk.shape[0]
        acc.update(
            blk,
            as_tensor(truth[s0:s1], torch.float32, device),
            None if w is None else w[s0:s1],
            None if climatology is None else as_tensor(climatology[s0:s1], torch.float32, device),
        )
    return acc.finalize()
