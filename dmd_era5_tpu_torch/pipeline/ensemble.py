"""One decomposition per (variable, level): the ensemble fit.

PyTorch counterpart of ``dmd_era5_tpu/pipeline/ensemble.py``.  Each member
is the (lat*lon, time) snapshot matrix of one variable at one pressure
level.  On one device each member takes the fused fit step
(``pipeline.train_step.fit_step_fused``: one launch of the fused kernel
K1 on the card) with one shared Gaussian sketch, in turn.  On a mesh the
members, a (B, S, T) batch padded with zero members to a multiple of the
``data`` axis, go through the meshed step (``train_step.fit_step``: K1
once a member of the rank's block), each rank reading only its block of
the members (a numpy memmap is read only there); the state then comes back
whole to every rank, as the JAX function returns it.  With ``solve_dmd``
every member then goes through one batched LM
(``models.optdmd.optdmd_from_svd_batched``) on the whole state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dmd_era5_tpu_torch.models.optdmd import BatchedOptDMDResult, optdmd_from_svd_batched
from dmd_era5_tpu_torch.parallel.collectives import all_gather, all_gather_packed
from dmd_era5_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_SPACE, AXIS_TIME, Mesh
from dmd_era5_tpu_torch.parallel.sharding import Layout, row_block
from dmd_era5_tpu_torch.pipeline import era5_svd
from dmd_era5_tpu_torch.pipeline.train_step import FitState, fit_step, fit_step_fused
from dmd_era5_tpu_torch.utils.labels import FieldSet

__all__ = ["EnsembleFit", "fit_per_variable_level"]

_MEMBER_DIMS = ("level", "latitude", "longitude", "time")


class EnsembleFit(NamedTuple):
    """labels: (variable, level) of each member, in order; state: a
    FitState whose u (B, S, k), s (B, k), v (B, k, T) and a_red (B, k, k)
    have the members along the leading axis, and loss the members' mean
    on one device, the whole batch's on a mesh (the meshed step's);
    dmd: the members' optimized-DMD fits with ``solve_dmd``, else None."""

    labels: list[tuple[str, int]]
    state: FitState
    dmd: BatchedOptDMDResult | None = None


def _member_matrices(fs: FieldSet) -> tuple[list[tuple[str, int]], list]:
    """Each member's (S, T) matrix, a view of its field's data where the
    layout allows (a numpy array or memmap, or a tensor, left where it
    lies), with its (variable, level) label."""
    levels = np.asarray(fs.coord("level").values)
    n_time = fs.sizes["time"]
    labels, members = [], []
    for var in fs.variables:
        field = fs[var]
        order = [field.axis(d) for d in _MEMBER_DIMS]
        data = field.data
        data = data.permute(order) if isinstance(data, torch.Tensor) else np.transpose(data, order)
        for li, lev in enumerate(levels):
            members.append(data[li].reshape(-1, n_time))
            labels.append((var, int(lev)))
    return labels, members


def _local_members(members: list, mesh: Mesh) -> torch.Tensor:
    """This rank's (data, space, time) block of the members' (B, S, T)
    batch, zero members padding B to a multiple of the ``data`` axis, on
    the mesh's device: only its own members' rows and columns are read
    (a numpy memmap's too, straight into a host block)."""
    b0, b1, per = row_block(len(members), mesh.shape[AXIS_DATA], mesh.coords[AXIS_DATA])
    cut = Layout(mesh, (AXIS_SPACE, AXIS_TIME))
    first = members[0]
    out = torch.zeros((per, *cut.local_block(first).shape), dtype=torch.float32,
                      device=first.device if isinstance(first, torch.Tensor) else "cpu")
    for j, member in enumerate(members[b0:b1]):
        block = cut.local_block(member)
        if isinstance(block, torch.Tensor):
            out[j] = block
        else:
            out[j].numpy()[...] = block
    return out.to(mesh.device)


def _whole_state(state: FitState, n_real: int, mesh: Mesh) -> FitState:
    """The meshed step's state whole on every rank: each member's U rows
    gathered over ``space`` in axis order (the rows divide the axis, so
    there is no padding to cut: ``parallel.assemble_rows``'s gather, kept
    on the device), then the members gathered over ``data`` in one packed
    gather and trimmed to the real ones.  A line of one rank moves
    nothing."""
    u, s, v, a_red = state.u, state.s, state.v, state.a_red
    if mesh.shape[AXIS_SPACE] > 1:
        u = all_gather(u, AXIS_SPACE, mesh, axis=1, tiled=True)
    if mesh.shape[AXIS_DATA] > 1:
        u, s, v, a_red = all_gather_packed([u, s, v, a_red], AXIS_DATA, mesh)
    return FitState(u[:n_real], s[:n_real], v[:n_real], a_red[:n_real], state.loss)


def fit_per_variable_level(
    fs: FieldSet,
    n_components: int,
    mesh: Mesh | None = None,
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
    ``torch.Generator`` on the device seeded with ``seed`` (torch's
    numbers are not JAX's), unless ``omega`` gives it.  ``device``: where
    the fits run, the card unless given, or unless the fields hold
    tensors on another device; a member that is a block of rows of such
    a tensor is fitted where it lies, without a copy.

    ``mesh``: the members batched over its ``data`` axis, each member's
    rows over ``space`` (and its columns over ``time``), on the mesh's
    device (``dmd_era5_tpu/pipeline/ensemble.py:42-113``): every rank of
    the mesh calls this, reads its block of the members (the rows and
    columns must divide their axes) and gets the whole state back.
    Without a mesh the members are fitted in turn on one device (the
    JAX function's default mesh, ``make_mesh()``, spans every device).
    """
    if mesh is not None:
        device = mesh.device
    else:
        device = era5_svd._device(device, fs.first())
    n_time = fs.sizes["time"]
    if omega is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        omega = torch.randn((n_time, n_components + n_oversamples), generator=gen,
                            dtype=torch.float32, device=device)
    omega = era5_svd._as_tensor(omega, device)

    if mesh is not None:
        labels, members = _member_matrices(fs)
        x_loc = _local_members(members, mesh)
        del members
        state = fit_step(x_loc, omega, mesh, n_components, gemm_dtype)
        del x_loc  # freed before the gather, which holds the whole state
        state = _whole_state(state, len(labels), mesh)
    else:
        labels, state = _fit_one_device(fs, omega, n_components, gemm_dtype, device)

    dmd = None
    if solve_dmd:
        from dmd_era5_tpu_torch.pipeline.era5_dmd import _hours_since_start

        t_hours = _hours_since_start(np.asarray(fs.coord("time").values))
        dmd = optdmd_from_svd_batched(state.u, state.s, state.v, t_hours, rank=dmd_rank,
                                      max_iter=dmd_max_iter)
    return EnsembleFit(labels, state, dmd)


def _fit_one_device(fs: FieldSet, omega: torch.Tensor, n_components: int,
                    gemm_dtype: torch.dtype, device: torch.device
                    ) -> tuple[list[tuple[str, int]], FitState]:
    """The members in turn through ``fit_step_fused`` on ``device``; the
    loss is the members' mean."""
    levels = np.asarray(fs.coord("level").values)
    n_time = fs.sizes["time"]
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
    return labels, state
