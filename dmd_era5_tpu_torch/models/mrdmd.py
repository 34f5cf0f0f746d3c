"""Multiresolution DMD (mrDMD): hierarchical slow/fast mode separation.

PyTorch counterpart of ``dmd_era5_tpu/models/mrdmd.py`` (Kutz, Fu &
Brunton, SIAM J. Appl. Dyn. Syst., 2016): split the time axis in halves
level by level, fit DMD on each window, keep the window's SLOW modes
(at most ``max_cycles`` oscillations over the window), subtract their
reconstruction and go on with the residual.  The slow/fast split is a
boolean mask folded into the amplitudes, so every shape is fixed.

Three routes, as in the JAX package:

- :func:`fit_mrdmd` on a snapshot matrix on its device.  The residual is
  ONE row-major (S, T_used) tensor; the window w of level l is its
  column block [w T_l, (w + 1) T_l), so splitting a window in two moves
  nothing.  Each window's T_l x T_l Gram is the Gram kernel (K4,
  ``ops.qr_panel.gram`` at ``"highest"``) on a card tensor, one launch a
  window: K4 takes a dense row-major panel, so a window narrower than
  the residual is copied once (at most S x T_used / 2 floats, level 1),
  and that copy serves the window's other products.  Those, the
  subtraction of the slow part included, are full-f32 ``torch.matmul``;
  the r x r eigenproblem and the amplitude solves run in complex128 on
  the device through ``utils/linalg.py``.
- :func:`mrdmd_from_svd` in the POD subspace of a truncated SVD (the
  stage's default), each level's modes lifted by one real GEMM a window.
- :func:`fit_mrdmd_gram` from the (T, T) Gram X^T X alone, a copy of the
  JAX package's f64 host algebra, and :func:`fit_mrdmd_streamed`, whose
  one pass over a packed artifact sums each block's Gram (K4 on the
  card) into an f64 (T, T) tensor on the device.

The per-level spectra, amplitudes and masks are small host arrays, as
in the JAX package; the modes and the residual are tensors on the fit's
device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dmd_era5_tpu_torch.models.optdmd import _lift_modes
from dmd_era5_tpu_torch.ops.qr_panel import gram
from dmd_era5_tpu_torch.utils.linalg import complex_solve, eig_sorted, gram_whiten
from dmd_era5_tpu_torch.utils.tensors import as_tensor, home_device

__all__ = [
    "MrDMDLevel",
    "MrDMDResult",
    "fit_mrdmd",
    "fit_mrdmd_gram",
    "fit_mrdmd_streamed",
    "mrdmd_from_svd",
    "mrdmd_reconstruct",
]

_FRO_ROWS = 1 << 20  # rows of a residual summed at a time by _fro


class MrDMDLevel(NamedTuple):
    """One level: ``n_windows = 2**level`` windows of ``t_window``
    snapshots.  omega (n_windows, r) complex64 continuous-time
    eigenvalues; amplitudes (n_windows, r) complex64 against unit modes,
    zero where a mode is not kept; slow_mask (n_windows, r) bool, the
    |omega| <= rho criterion; modes (n_windows, S, r) complex64 unit
    columns on the fit's device, or None; kept_mask: the modes whose
    amplitudes were kept (all of them at the finest level, which takes
    the remainder); mode_map (n_windows, T_used, r) complex64 (Gram route
    only): modes = X[:, :T_used] @ mode_map[w], unit columns."""

    level: int
    omega: np.ndarray
    amplitudes: np.ndarray
    slow_mask: np.ndarray
    modes: torch.Tensor | None
    t_window: int
    kept_mask: np.ndarray | None = None
    mode_map: np.ndarray | None = None


class MrDMDResult(NamedTuple):
    """levels coarse (level 0, one window over T_used) to fine; residual
    (S, T_used), what no level captured, on the fit's device (None on the
    Gram route); t_used the leading snapshots decomposed (T cut to a
    multiple of 2**(max_levels - 1)); residual_fro ||residual||_F;
    x_fro ||X[:, :T_used]||_F (Gram route)."""

    levels: list
    residual: torch.Tensor | None
    dt: float
    t_used: int
    residual_fro: float | None = None
    x_fro: float | None = None


def _t_used(t_total: int, rank: int, max_levels: int) -> int:
    n_fine = 2 ** (max_levels - 1)
    t_used = (t_total // n_fine) * n_fine
    if t_used // n_fine < rank + 2:
        raise ValueError(
            f"finest window has {t_used // n_fine} snapshots; "
            f"need >= rank + 2 = {rank + 2} (reduce max_levels or rank)"
        )
    return t_used


def _fro(x: torch.Tensor) -> float:
    """||x||_F, the squares of row chunks' norms summed in f64."""
    return math.sqrt(sum(float(torch.linalg.vector_norm(x[r0 : r0 + _FRO_ROWS])) ** 2
                         for r0 in range(0, x.shape[0], _FRO_ROWS)))


def _level_core(xw: torch.Tensor, rank: int):
    """A window's DMD factors from one pass of skinny GEMMs.

    xw (S, T_l) float32, dense row-major.  Returns (m, atilde, mtm, mtx0):
    m = X2 V S^-1 (S, r), the real pre-factor of the exact modes
    Phi = m W; atilde (r, r) the reduced operator; mtm = m^T m and
    mtx0 = m^T x0, the pieces of the amplitude normal equations.  The
    Gram route's truncated SVD of X1 = xw[:, :-1]: eigh of its Gram (the
    leading block of K4's Gram of xw), then a Rayleigh-Ritz SVD through
    the CholQR2-whitened y = X1 V_r.
    """
    g = gram(xw, "highest")[:-1, :-1]
    _, vecs = torch.linalg.eigh(g)  # ascending
    v_r = vecs.flip(-1)[:, :rank]  # (T_l - 1, r), the top subspace
    y = xw[:, :-1] @ v_r
    w = gram_whiten(y.T @ y, base_ridge=1e-7)  # Q = y W^T, never formed
    c_full = y.T @ xw  # (r, T_l): y^T X1 and y^T X2 from one pass
    u_b, s, vt = torch.linalg.svd(w @ c_full[:, :-1], full_matrices=False)
    # directions under the Gram route's sqrt(eps_f32) floor are dead: a
    # zero inverse, not 1/s amplifying junk into the subtraction
    s0 = torch.clamp(s[:1], min=1e-30)
    s_inv = torch.where(s > 1e-3 * s0, 1.0 / torch.clamp(s, min=1e-30), torch.zeros_like(s))
    proj2 = u_b.T @ (w @ c_full[:, 1:])  # U^T X2 with U = y (W^T u_b)
    vs = vt * s_inv[:, None]  # (V S^-1)^T, (r, T_l - 1)
    atilde = proj2 @ vs.T
    m = xw[:, 1:] @ vs.T  # (S, r)
    return m, atilde, m.T @ m, m.T @ xw[:, 0]


def _window_fit(atilde, mtm, mtx0, t_l: int, dt: float, rho: float, keep_all: bool):
    """The r x r algebra of one window, complex128 on the device: the
    eigenvalues and vectors of atilde, omega, the masks, the amplitudes
    (Phi^H Phi) b = Phi^H x0 with Phi = m W, the mode norms and the real
    slow-part coefficients K = Re(W diag(b_kept) exp(omega t)) (r, T_l).
    Returns (omega, amplitudes of unit modes, slow, kept) as host arrays
    and (W, norms, K) on the device."""
    lam, wvec = eig_sorted(atilde.double(), torch.complex128)
    lam = torch.where(lam.abs() < 1e-12, torch.full_like(lam, 1e-12), lam)
    omega = (torch.log(lam) / dt).to(torch.complex64)
    slow = omega.abs().double() <= rho
    kept = torch.ones_like(slow) if keep_all else slow
    wh = wvec.mH
    php = wh @ mtm.double().to(torch.complex128) @ wvec
    rhs = wh @ mtx0.double().to(torch.complex128)
    # scaled Tikhonov ridge for a window an earlier level captured
    ridge = 1e-9 * max(abs(complex(torch.trace(php))), 1.0)
    eye = torch.eye(php.shape[0], dtype=php.dtype, device=php.device)
    amps = complex_solve(php + ridge * eye, rhs[:, None])[:, 0]
    amps_kept = torch.where(kept, amps, torch.zeros_like(amps))
    # exp over the kept modes only: a masked fast mode with a large growth
    # rate would overflow, and 0 * inf poisons the product
    omega_kept = torch.where(kept, omega.to(torch.complex128), torch.zeros_like(amps))
    t_local = torch.arange(t_l, dtype=torch.float64, device=omega.device) * dt
    dyn = amps_kept[:, None] * torch.exp(omega_kept[:, None] * t_local[None, :])
    k_re = (wvec @ dyn).real.float()
    norms = torch.sqrt(torch.clamp(torch.diagonal(php).real, min=0.0))
    host = (omega.cpu().numpy(), (amps_kept * norms).to(torch.complex64).cpu().numpy(),
            slow.cpu().numpy(), kept.cpu().numpy())
    return host, (wvec, norms, k_re)


def fit_mrdmd(
    x,
    dt: float = 1.0,
    rank: int = 8,
    max_levels: int = 4,
    max_cycles: float = 1.0,
    return_modes: bool = True,
    device: torch.device | str | None = None,
) -> MrDMDResult:
    """Multiresolution DMD of a (S, T) snapshot matrix.

    Counterpart of ``dmd_era5_tpu/models/mrdmd.py:210``.  ``rank``: DMD
    rank per window; level l has 2**l windows; T is cut to a multiple of
    2**(max_levels - 1), and the finest window must keep rank + 2
    snapshots.  A mode is slow for its level when |omega| <= 2 pi
    max_cycles / (T_l dt); the finest level keeps every mode.
    ``return_modes``: keep each level's (n_windows, S, r) complex modes.
    ``device``: where the fit runs, by default where x lies (the card for
    a host array).  The sum of the levels' slow parts
    (:func:`mrdmd_reconstruct`) equals x[:, :t_used] - residual.

    Device memory: x, the residual (S x T_used), one window's copy (at
    most half of that) and the modes.
    """
    device = home_device(x, device)
    x = as_tensor(x, torch.float32, device)
    s_rows, t_total = x.shape
    t_used = _t_used(t_total, rank, max_levels)
    resid = torch.clone(x[:, :t_used], memory_format=torch.contiguous_format)

    levels: list[MrDMDLevel] = []
    for level in range(max_levels):
        n_win = 2**level
        t_l = t_used // n_win
        rho = 2.0 * math.pi * max_cycles / (t_l * dt)
        host = []
        modes = (torch.empty((n_win, s_rows, rank), dtype=torch.complex64, device=device)
                 if return_modes else None)
        for win in range(n_win):
            block = resid[:, win * t_l : (win + 1) * t_l]
            xw = resid if n_win == 1 else block.contiguous()  # K4 takes a dense panel
            m, atilde, mtm, mtx0 = _level_core(xw, rank)
            del xw
            win_host, (wvec, norms, k_re) = _window_fit(
                atilde, mtm, mtx0, t_l, dt, rho, keep_all=level == max_levels - 1)
            host.append(win_host)
            if return_modes:
                safe = torch.where(norms < 1e-30, torch.ones_like(norms), norms)
                modes[win] = _lift_modes(m, wvec) / safe[None, :].float()
            block.addmm_(m, k_re, alpha=-1.0)  # the slow part out of the residual
            del m
        omega, amps, slow, kept = (np.stack(a) for a in zip(*host))
        levels.append(MrDMDLevel(level, omega, amps, slow, modes, t_l, kept))
    return MrDMDResult(levels, resid, dt, t_used, residual_fro=_fro(resid))


def mrdmd_from_svd(
    u,
    s,
    v,
    dt: float = 1.0,
    rank: int | None = None,
    max_levels: int = 3,
    max_cycles: float = 1.0,
) -> MrDMDResult:
    """Multiresolution DMD in the POD subspace of a truncated SVD, on U's
    device.

    Counterpart of ``dmd_era5_tpu/models/mrdmd.py:361``: the hierarchy is
    fit on the projected snapshots Z = S V^T (k, T), and each window's
    modes are lifted to full space by one real GEMM against U (then unit
    columns again, the norms folded into the amplitudes).  The residual
    is in the projected space, (k, T_used).  Every level shares the one
    global basis U, so per-window dynamics outside it are invisible
    (the JAX docstring's approximation note; ``mr_refit_rank`` in the
    stage refits on the raw matrix instead).  u (S, k), s (k,), v (k, T);
    rank per window (default k).
    """
    device = home_device(u)
    u = as_tensor(u, torch.float32, device)
    k = int(s.shape[0])
    z = as_tensor(s, torch.float32, device)[:, None] * as_tensor(v, torch.float32, device)
    res = fit_mrdmd(z, dt=dt, rank=rank or k, max_levels=max_levels, max_cycles=max_cycles,
                    return_modes=True)
    lifted = []
    for lv in res.levels:
        n_win, _, r = lv.modes.shape
        modes = torch.empty((n_win, u.shape[0], r), dtype=torch.complex64, device=device)
        norms = np.empty((n_win, r), np.float32)
        for win in range(n_win):
            m = _lift_modes(u, lv.modes[win])
            nrm = torch.linalg.vector_norm(m, dim=0)
            safe = torch.where(nrm < 1e-30, torch.ones_like(nrm), nrm)
            modes[win] = m / safe[None, :]
            norms[win] = safe.cpu().numpy()
            del m
        lifted.append(lv._replace(modes=modes,
                                  amplitudes=(lv.amplitudes * norms).astype(np.complex64)))
    return res._replace(levels=lifted)


def mrdmd_reconstruct(result: MrDMDResult) -> torch.Tensor:
    """The sum of every level's slow part, (S, T_used) float32 on the
    modes' device: x[:, :t_used] - residual to f32 roundoff.  Needs the
    modes (``return_modes=True``).  A caller that wants it in row blocks
    passes a result whose modes are sliced to those rows."""
    first = result.levels[0]
    if first.modes is None:
        raise ValueError("fit_mrdmd(return_modes=True) is required")
    device = first.modes.device
    out = torch.zeros((first.modes.shape[1], result.t_used), dtype=torch.float32,
                      device=device)
    for lv in result.levels:
        t_l = lv.t_window
        t_local = np.arange(t_l) * result.dt
        kept = lv.kept_mask if lv.kept_mask is not None else lv.slow_mask
        omega_kept = np.where(kept, lv.omega, 0.0)  # 0 * inf guard
        for win in range(lv.omega.shape[0]):
            dyn = lv.amplitudes[win][:, None] * np.exp(omega_kept[win][:, None] * t_local[None, :])
            d = torch.from_numpy(dyn.astype(np.complex64)).to(device)
            modes = lv.modes[win]
            out[:, win * t_l : (win + 1) * t_l] += modes.real @ d.real - modes.imag @ d.imag
    return out


def fit_mrdmd_gram(
    gx: np.ndarray,
    dt: float = 1.0,
    rank: int = 8,
    max_levels: int = 4,
    max_cycles: float = 1.0,
) -> MrDMDResult:
    """Multiresolution DMD from the T x T Gram of the snapshot matrix.

    A copy of ``dmd_era5_tpu/models/mrdmd.py:471``'s f64 host algebra.
    The level-l residual is always X @ C for a small per-window time-side
    map C (C = I at level 0, and each subtraction only composes maps:
    C_child = C[:, half] - C[:, 1:] (V S^-1) K[:, half]), so every
    window's Gram is C^T Gx C and the whole hierarchy (spectra,
    amplitudes, masks, the residual's norm) follows from Gx.  The modes
    come back as time-side ``mode_map`` factors (Phi_w = X @
    mode_map[w], unit columns).  The relative dead-direction cutoff is
    1e-3, as in :func:`fit_mrdmd`.  gx (T, T) float64 X^T X.
    """
    gx = np.asarray(gx, np.float64)
    t_used = _t_used(gx.shape[0], rank, max_levels)
    gx = gx[:t_used, :t_used]

    cmaps: list[np.ndarray] = [np.eye(t_used)]  # R_w = X[:, :t_used] @ cmaps[w]
    levels: list[MrDMDLevel] = []
    for level in range(max_levels):
        t_l = t_used // (2**level)
        n_win = len(cmaps)
        omega_l = np.zeros((n_win, rank), np.complex64)
        amps_l = np.zeros((n_win, rank), np.complex64)
        slow_l = np.zeros((n_win, rank), bool)
        kept_l = np.zeros((n_win, rank), bool)
        maps_l = np.zeros((n_win, t_used, rank), np.complex64)
        next_maps: list[np.ndarray] = []
        rho = 2.0 * np.pi * max_cycles / (t_l * dt)

        for w, c in enumerate(cmaps):
            gw = c.T @ gx @ c  # (T_l, T_l) window Gram
            evals, vecs = np.linalg.eigh(gw[:-1, :-1])
            idx = np.argsort(evals)[::-1][:rank]
            s = np.sqrt(np.maximum(evals[idx], 0.0))
            s0 = max(s[0], 1e-300)
            s_inv = np.where(s > 1e-3 * s0, 1.0 / np.maximum(s, 1e-300), 0.0)
            vs = vecs[:, idx] * s_inv[None, :]  # V S^-1, (T_l - 1, r)

            atilde = vs.T @ gw[:-1, 1:] @ vs  # S^-1 V^T (X1^T X2) V S^-1
            lam, wvec = np.linalg.eig(atilde)
            lam = np.where(np.abs(lam) < 1e-12, 1e-12, lam).astype(np.complex128)
            omega = (np.log(lam) / dt).astype(np.complex64)
            slow = np.abs(omega) <= rho
            kept = np.ones_like(slow) if level == max_levels - 1 else slow

            # M = X2 (V S^-1): mtm = vs^T G22 vs, mtx0 = vs^T (X2^T x0)
            mtm = vs.T @ gw[1:, 1:] @ vs
            mtx0 = vs.T @ gw[1:, 0]
            wh = np.conj(wvec.T)
            php = wh @ mtm @ wvec
            ridge = 1e-9 * max(abs(np.trace(php)), 1.0)
            amps = np.linalg.solve(php + ridge * np.eye(rank), wh @ mtx0)
            amps_slow = np.where(kept, amps, 0.0)

            omega_kept = np.where(kept, omega.astype(np.complex128), 0.0)
            t_local = np.arange(t_l) * dt
            dyn = amps_slow[:, None] * np.exp(omega_kept[:, None] * t_local[None, :])
            k_re = np.real(wvec @ dyn)  # (r, T_l)

            norms = np.sqrt(np.maximum(np.real(np.diag(php)), 0.0))
            safe = np.where(norms < 1e-30, 1.0, norms)
            maps_l[w] = ((c[:, 1:] @ vs) @ wvec / safe[None, :]).astype(np.complex64)
            omega_l[w] = omega
            amps_l[w] = (amps_slow * norms).astype(np.complex64)
            slow_l[w] = slow
            kept_l[w] = kept

            # children: the slow part subtracted IN THE MAP, then split
            c_res = c - (c[:, 1:] @ vs) @ k_re
            if level + 1 < max_levels:
                half = t_l // 2
                next_maps.extend([c_res[:, :half], c_res[:, half:]])
            else:
                next_maps.append(c_res)

        levels.append(MrDMDLevel(level, omega_l, amps_l, slow_l, None, t_l, kept_l, maps_l))
        cmaps = next_maps

    res_sq = sum(float(np.trace(c.T @ gx @ c)) for c in cmaps)  # ||X C||^2
    return MrDMDResult(levels, None, dt, t_used,
                       residual_fro=float(np.sqrt(max(res_sq, 0.0))),
                       x_fro=float(np.sqrt(max(np.trace(gx), 0.0))))


def fit_mrdmd_streamed(
    path,
    dt: float = 1.0,
    rank: int = 8,
    max_levels: int = 4,
    max_cycles: float = 1.0,
    block_rows: int = 1 << 16,
    return_modes: bool = False,
    device=None,
) -> MrDMDResult:
    """Multiresolution DMD of a packed snapshot artifact, out of core.

    Counterpart of ``dmd_era5_tpu/models/mrdmd.py:617``: ONE pass over
    the artifact (``pipeline.streamed_fit._device_blocks``) takes
    each block's Gram on ``device`` (K4 on the card, one launch a block;
    a bf16 artifact's blocks as they are) and adds it into an f64 (T, T)
    sum there; :func:`fit_mrdmd_gram` does the rest on the host.  With
    ``return_modes`` a second pass forms each level's (n_windows, S, r)
    modes on ``device`` from the time-side maps, one real GEMM per
    block, level and window.  ``device=None`` is the card.
    """
    from dmd_era5_tpu_torch.pipeline import streamed_fit
    from dmd_era5_tpu_torch.snapmat.loader import packed_info

    device = streamed_fit._device(device)
    (n_rows, t_cols), _, _ = packed_info(path)
    gx = torch.zeros((t_cols, t_cols), dtype=torch.float64, device=device)
    for _, blk in streamed_fit._device_blocks(path, n_rows, t_cols, block_rows, device):
        gx += gram(blk, "highest").double()
    res = fit_mrdmd_gram(gx.cpu().numpy(), dt=dt, rank=rank, max_levels=max_levels,
                         max_cycles=max_cycles)
    if not return_modes:
        return res

    t_used = res.t_used
    maps = [torch.from_numpy(lv.mode_map).to(device) for lv in res.levels]
    modes = [torch.empty((m.shape[0], n_rows, rank), dtype=torch.complex64, device=device)
             for m in maps]
    for r0, blk in streamed_fit._device_blocks(path, n_rows, t_cols, block_rows, device):
        xb = blk.float()[:, :t_used]
        for level_maps, level_modes in zip(maps, modes):
            for win in range(level_maps.shape[0]):
                level_modes[win, r0 : r0 + xb.shape[0]] = _lift_modes(xb, level_maps[win])
    return res._replace(levels=[lv._replace(modes=m) for lv, m in zip(res.levels, modes)])
