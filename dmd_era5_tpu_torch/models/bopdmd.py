"""BOP-DMD: bagging, optimized dynamic mode decomposition.

PyTorch counterpart of ``dmd_era5_tpu/models/bopdmd.py`` (Sashidhar &
Kutz, Phil. Trans. R. Soc. A, 2022): optimized DMD fit on many random
snapshot subsets, reported as trial means and standard deviations of
the eigenvalues, modes and amplitudes.

The trials run as one batched LM (:func:`varpro_lm_batched`, one row of
sample times per trial) in the k-dimensional POD space, on U's device.
Trial subsets are drawn on the host from ``np.random.default_rng(seed)``,
so one seed gives this package and the JAX one the same subsets.  The
modes are lifted, phase-aligned and summed one trial at a time (the sum
of the modes and of their squared magnitude, in float64), so no
(n_trials, S, r) array is formed: device memory is U plus five (S, r)
complex64-sized arrays, whatever the bag size.  On a mesh the trials
split over its ``data`` axis (:func:`varpro_lm_batched`); the anchor
fit, the alignment and the aggregation run whole on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dmd_era5_tpu_torch.models.optdmd import (
    OptDMDResult,
    _lift_modes,
    optdmd_from_svd,
    varpro_lm_batched,
)
from dmd_era5_tpu_torch.utils.tensors import as_tensor

__all__ = ["BOPDMDResult", "bopdmd_from_svd", "fit_bopdmd"]


class BOPDMDResult(NamedTuple):
    """Trial statistics of a bagged optimized-DMD fit, tensors on U's
    device.

    eigenvalues / modes / amplitudes are the TRIAL MEANS (the BOP-DMD
    point estimate; the mean modes with unit columns); the ``*_std``
    fields are elementwise standard deviations across trials (complex
    quantities: sqrt(var_re + var_im)).  ``full`` is the full-data fit
    that initializes and aligns the trials.
    """

    eigenvalues: torch.Tensor  # (r,) complex mean
    eigenvalues_std: torch.Tensor  # (r,) real
    modes: torch.Tensor  # (S, r) complex mean, unit columns
    modes_std: torch.Tensor  # (S, r) real
    amplitudes: torch.Tensor  # (r,) real mean
    amplitudes_std: torch.Tensor  # (r,) real
    full: OptDMDResult
    trial_eigenvalues: torch.Tensor  # (n_trials, r) complex, aligned
    n_iters: torch.Tensor  # (n_trials,)


def _align_to_anchor(alpha_trials: np.ndarray, anchor: np.ndarray) -> np.ndarray:
    """Per-trial permutation matching each trial's eigenvalues to the
    anchor's (optimal assignment on complex distance).

    Bagged trials converge to the same spectrum in arbitrary order;
    averaging without alignment would mix distinct eigenvalues.
    Returns (n_trials, r) integer indices: trial row -> anchor slot.
    """
    from scipy.optimize import linear_sum_assignment

    n_trials, r = alpha_trials.shape
    perms = np.empty((n_trials, r), dtype=np.int64)
    for i in range(n_trials):
        cost = np.abs(anchor[:, None] - alpha_trials[i][None, :])
        rows, cols = linear_sum_assignment(cost)
        perms[i, rows] = cols
    return perms


def _cstd(x: np.ndarray) -> np.ndarray:
    """sqrt(var_re + var_im) over trials (axis 0), ddof 0."""
    return np.sqrt(np.var(x.real, axis=0) + np.var(x.imag, axis=0)).astype(np.float32)


def _aggregate_modes(
    u: torch.Tensor, anchor: torch.Tensor, coefs: np.ndarray
) -> tuple[torch.Tensor, torch.Tensor]:
    """The trials' mean modes (unit columns) and modes std, streamed.

    u (S, k) real, anchor (S, r) the full fit's modes, coefs (n_trials,
    k, r) each trial's unit-amplitude POD coefficients.  Each trial's
    modes U c are lifted, rotated by -arg(<anchor_j, mode_j>) (the
    eigenvector phase is a gauge freedom; without the rotation the mean
    cancels) and added to float64 sums of the modes and of their squared
    magnitude, so std = sqrt(E|m|^2 - |E m|^2) = sqrt(var_re + var_im).
    """
    # <anchor_j, U c_j> = (anchor^H U c)_jj: one (r, k) product, no S-sized
    # temporary a trial
    proj = torch.complex(anchor.real.T @ u, -(anchor.imag.T @ u))
    total = torch.zeros(anchor.shape, dtype=torch.complex128, device=u.device)
    power = torch.zeros(anchor.shape, dtype=torch.float64, device=u.device)
    for coef in coefs:
        c = as_tensor(coef, torch.complex64, u.device)
        inner = (proj * c.T).sum(dim=1)
        absin = inner.abs()
        phase = torch.where(absin == 0, torch.ones_like(inner),
                            inner / torch.where(absin == 0, torch.ones_like(absin), absin))
        m = _lift_modes(u, c * phase.conj()[None, :])
        total.add_(m)
        power.addcmul_(m.real, m.real).addcmul_(m.imag, m.imag)
        del m  # freed before the next trial's lift
    n = len(coefs)
    mean = total.div_(n)
    power.div_(n).addcmul_(mean.real, mean.real, value=-1).addcmul_(mean.imag, mean.imag, value=-1)
    std = power.clamp_(min=0).sqrt_().float()
    del power
    modes = mean.to(torch.complex64)
    del mean, total
    norms = torch.linalg.vector_norm(modes, dim=0)
    modes /= torch.where(norms == 0, torch.ones_like(norms), norms)[None, :]
    return modes, std


def bopdmd_from_svd(
    u: torch.Tensor,
    s: torch.Tensor,
    v: torch.Tensor,
    t,
    rank: int | None = None,
    n_trials: int = 20,
    trial_fraction: float = 0.8,
    seed: int = 0,
    max_iter: int = 50,
    tol: float = 1e-7,
    mesh=None,
) -> BOPDMDResult:
    """Bagged optimized DMD from the truncated SVD of the snapshots.

    u (S, k), s (k,), v (k, T) on one device, t (T,) sample times;
    rank r <= k eigenvalues per fit (default k); ``n_trials`` subsets of
    ``trial_fraction`` of the snapshots each, in time order, drawn from
    ``np.random.default_rng(seed)``.  Every trial starts from the
    full-data fit's eigenvalues, so the bag explores the resampling,
    not the optimizer's basins.  Trials whose fit diverged (non-finite
    eigenvalues or coefficients) are dropped; if all did, RuntimeError.

    ``mesh``: the trials' LM solves split over its ``data`` axis, with
    one gather over it (:func:`varpro_lm_batched`); every rank draws the
    same subsets from ``seed`` and returns the same result.  U, s and V
    are whole on every rank, and the full-data anchor fit runs on each
    rank's one device, as in every JAX process.
    """
    k = s.shape[-1]
    rank = rank or int(k)
    if not (0.0 < trial_fraction <= 1.0):
        raise ValueError(f"trial_fraction must be in (0, 1]: {trial_fraction}")
    t = as_tensor(t, torch.float32, u.device)
    n_time = t.shape[0]
    p = max(rank + 1, int(round(trial_fraction * n_time)))
    if p > n_time:
        raise ValueError(
            f"trial size {p} exceeds {n_time} snapshots (rank {rank} "
            f"needs at least rank+1 samples per trial)"
        )

    # full-data fit: the anchor (trial init + eigenvalue alignment)
    full = optdmd_from_svd(u, s, v, t, rank=rank, max_iter=max_iter, tol=tol)

    rng = np.random.default_rng(seed)
    idx = np.stack(
        [np.sort(rng.choice(n_time, size=p, replace=False)) for _ in range(n_trials)]
    )  # (n_trials, p), time-ordered
    idx = torch.from_numpy(idx).to(u.device)
    h_full = (s[:, None] * v).T  # (T, k) projected snapshots
    alpha0 = full.alpha[None, :].expand(n_trials, -1)
    alpha_t, b_t, _rel, n_iters = varpro_lm_batched(
        h_full[idx], t[idx], alpha0, max_iter=max_iter, tol=tol, mesh=mesh
    )

    # drop diverged trials: a fit on a hard subset can run a growth rate
    # to +inf, poisoning the means
    valid = np.isfinite(alpha_t).all(axis=1) & np.isfinite(b_t).all(axis=(1, 2))
    if not valid.any():
        raise RuntimeError(
            f"all {n_trials} bagging trials diverged; the full-data fit "
            f"residual is {float(full.residual):.3e} — lower rank or "
            "raise trial_fraction"
        )
    alpha_t, b_t, n_iters = alpha_t[valid], b_t[valid], n_iters[valid]

    # align trials to the anchor spectrum, then aggregate
    perms = _align_to_anchor(alpha_t, full.alpha.cpu().numpy())
    rows = np.arange(len(alpha_t))[:, None]
    alpha_t = alpha_t[rows, perms]  # (n_trials, r)
    b_t = b_t[rows, perms]  # (n_trials, r, k)
    amps_t = np.linalg.norm(b_t, axis=2)  # (n_trials, r)
    safe = np.where(amps_t == 0, 1.0, amps_t)
    coefs = (b_t / safe[..., None]).transpose(0, 2, 1)  # (n_trials, k, r)
    modes, modes_std = _aggregate_modes(u.float(), full.modes, coefs)

    def dev(a, dtype):
        return as_tensor(a, dtype, u.device)

    return BOPDMDResult(
        eigenvalues=dev(alpha_t.mean(axis=0), torch.complex64),
        eigenvalues_std=dev(_cstd(alpha_t), torch.float32),
        modes=modes,
        modes_std=modes_std,
        amplitudes=dev(amps_t.mean(axis=0), torch.float32),
        amplitudes_std=dev(amps_t.std(axis=0), torch.float32),
        full=full,
        trial_eigenvalues=dev(alpha_t, torch.complex64),
        n_iters=dev(n_iters, torch.int32),
    )


def fit_bopdmd(
    x: torch.Tensor,
    t,
    rank: int,
    n_trials: int = 20,
    trial_fraction: float = 0.8,
    seed: int = 0,
    max_iter: int = 50,
    tol: float = 1e-7,
    mesh=None,
) -> BOPDMDResult:
    """Bagged optimized DMD of a (S, T) snapshot matrix on its device,
    through its full f32 SVD truncated to ``rank``; ``mesh`` as in
    :func:`bopdmd_from_svd` (x whole on every rank)."""
    u, sv, vt = torch.linalg.svd(x.float(), full_matrices=False)
    return bopdmd_from_svd(
        u[:, :rank], sv[:rank], vt[:rank, :], t, rank=rank, n_trials=n_trials,
        trial_fraction=trial_fraction, seed=seed, max_iter=max_iter, tol=tol, mesh=mesh,
    )
