"""One decomposition per (variable, level): the ensemble fit.

PyTorch counterpart of ``dmd_era5_tpu/pipeline/ensemble.py`` on one
device.  Each member is the (lat*lon, time) snapshot matrix of one
variable at one pressure level; each takes the fused fit step
(``pipeline.train_step.fit_step_fused``: one launch of the fused kernel
K1 on the card) with one shared Gaussian sketch, in turn, where the JAX
package batches the members over its mesh's ``data`` axis.  With
``solve_dmd`` every member then goes through one batched LM
(``models.optdmd.optdmd_from_svd_batched``).

A mesh (the JAX ensemble's meshed ``make_fit_step``) is not taken yet
(ROADMAP Queue 1 item 12, step 9c) and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dmd_era5_tpu_torch.models.optdmd import NO_MESH, BatchedOptDMDResult, optdmd_from_svd_batched
from dmd_era5_tpu_torch.pipeline import era5_svd
from dmd_era5_tpu_torch.pipeline.train_step import FitState, fit_step_fused
from dmd_era5_tpu_torch.utils.labels import FieldSet

__all__ = ["EnsembleFit", "fit_per_variable_level"]

_MEMBER_DIMS = ("level", "latitude", "longitude", "time")


class EnsembleFit(NamedTuple):
    """labels: (variable, level) of each member, in order; state: a
    FitState whose u (B, S, k), s (B, k), v (B, k, T) and a_red (B, k, k)
    have the members along the leading axis, and loss the members' mean;
    dmd: the members' optimized-DMD fits with ``solve_dmd``, else None."""

    labels: list[tuple[str, int]]
    state: FitState
    dmd: BatchedOptDMDResult | None = None


def fit_per_variable_level(
    fs: FieldSet,
    n_components: int,
    mesh=None,
    n_oversamples: int = 10,
    seed: int = 0,
    gemm_dtype: torch.dtype = torch.float32,
    solve_dmd: bool = False,
    dmd_rank: int | None = None,
    dmd_max_iter: int = 50,
    device: torch.device | str | None = None,
    omega=None,
) -> EnsembleFit:
    """Fit one decomposition per (variable, level) of ``fs``.

    The sketch (T, n_components + n_oversamples) is drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (torch's
    numbers are not JAX's), unless ``omega`` gives it.  ``device``: where
    the fits run, the card unless given, or unless the fields hold
    tensors on another device; a member that is a block of rows of such
    a tensor is fitted where it lies, without a copy.
    """
    if mesh is not None:
        raise NotImplementedError(f"fit_per_variable_level with a mesh: {NO_MESH}")
    device = era5_svd._device(device, fs.first())
    levels = np.asarray(fs.coord("level").values)
    n_time = fs.sizes["time"]
    if omega is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        omega = torch.randn((n_time, n_components + n_oversamples), generator=gen,
                            dtype=torch.float32, device=device)
    omega = era5_svd._as_tensor(omega, device)

    labels: list[tuple[str, int]] = []
    states: list[FitState] = []
    for var in fs.variables:
        field = fs[var]
        data = era5_svd._as_tensor(field.data, device)
        data = data.permute([field.axis(d) for d in _MEMBER_DIMS])  # (level, lat, lon, time)
        for li, lev in enumerate(levels):
            x = data[li].reshape(-1, n_time).contiguous()  # a view where data is row-major
            states.append(fit_step_fused(x, omega, n_components, gemm_dtype=gemm_dtype))
            labels.append((var, int(lev)))
            del x
        del data

    # each member's U is freed as soon as it is copied in
    u = torch.empty((len(states),) + tuple(states[0].u.shape), dtype=states[0].u.dtype,
                    device=device)
    for i, st in enumerate(states):
        u[i] = st.u
        states[i] = st._replace(u=None)
    state = FitState(
        u,
        torch.stack([st.s for st in states]),
        torch.stack([st.v for st in states]),
        torch.stack([st.a_red for st in states]),
        torch.stack([st.loss for st in states]).mean(),
    )
    del states

    dmd = None
    if solve_dmd:
        from dmd_era5_tpu_torch.pipeline.era5_dmd import _hours_since_start

        t_hours = _hours_since_start(np.asarray(fs.coord("time").values))
        dmd = optdmd_from_svd_batched(state.u, state.s, state.v, t_hours, rank=dmd_rank,
                                      max_iter=dmd_max_iter)
    return EnsembleFit(labels, state, dmd)
