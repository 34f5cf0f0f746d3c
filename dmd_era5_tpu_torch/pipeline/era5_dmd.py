"""The DMD stage: optimized, exact or bagged DMD, mrDMD, DMDc and the
forecast.

The port's counterpart of ``dmd_era5_tpu/pipeline/era5_dmd.py``, on one
device or a mesh of ranks.  :func:`main` runs the cache ladder (workdir attr match, then the
artifact store), else the SVD stage (``era5_svd.main``, with its own
ladder) and :func:`fit_dmd_from_svd_results`, then writes and versions
the artifact.  The fit takes one of three paths on the SVD factors:
optimized DMD (variable projection), exact DMD (the same solver with no
LM step) or bagged BOP-DMD (``bagging_trials > 0``).  Beside it, if
asked: an mrDMD hierarchy (``multiresolution_levels > 0``) in the POD
subspace, or with ``mr_refit_rank > 0`` refit on the raw embedded matrix
(the artifact's X, or without X streamed from the slice artifact through
a packed file: one Gram pass); a DMDc fit under a control series
(``control_input``: ``diurnal``, ``seasonal``, a ``.npy`` or an ``.h5``
file); the forecast scored on the withheld holdout (latitude-weighted
RMSE, ACC and bias per lead, and the persistence baseline's); and the
forecast field over the training window and ``forecast_steps`` beyond it.

U is moved to the device once (a tensor already there is used where it
lies) and freed once no fit needs it (before a raw mrDMD refit).  The
S-sized outputs stay on the device: the modes (the bag's modes std, the
mrDMD levels' and DMDc's modes) and the forecast field, which is filled
there row block by row block, so no (S*d, T') rollout is formed.  They
are tensors in the returned FieldSet, which ``save_fieldset`` writes slab
by slab; the small fields are host arrays, as in the JAX stage.

On a mesh (SPMD, one process a rank, every rank calling :func:`main`):
the SVD stage runs on it (``era5_svd.main``), the bag's trials split
over its ``data`` axis and DMDc's two Gram-route SVDs over its
``space`` axis; every other fit (optDMD, mrDMD, the scores, the
forecast) runs whole on each rank's one device, as in every JAX
process, and every rank returns the same FieldSet.  In a world of
several ranks rank 0 alone writes and versions the artifact; the others
wait for it and raise with it if it fails.

Run as ``python -m dmd_era5_tpu_torch.pipeline.era5_dmd``.
"""

from __future__ import annotations

import functools
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from dmd_era5_tpu_torch.core import config_parser, config_reader
from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.models.bopdmd import bopdmd_from_svd
from dmd_era5_tpu_torch.models.dmdc import dmdc_from_svd
from dmd_era5_tpu_torch.models.forecast import iter_forecast_blocks, streamed_forecast_scores
from dmd_era5_tpu_torch.models.mrdmd import _fro, fit_mrdmd, fit_mrdmd_streamed, mrdmd_from_svd
from dmd_era5_tpu_torch.models.optdmd import optdmd_from_svd
from dmd_era5_tpu_torch.models.verification import ScoreAccumulator, _space_weights
from dmd_era5_tpu_torch.pipeline import era5_svd
from dmd_era5_tpu_torch.snapmat import resample_era5_dataset, slice_era5_dataset
from dmd_era5_tpu_torch.snapmat.loader import save_packed_matrix
from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

__all__ = ["check_dmd_results", "fit_dmd_from_svd_results", "retrieve_dmd_results", "main"]


@functools.cache
def _logger():
    return setup_logger("ERA5-DMD-torch", "era5_dmd_torch.log")


def _all_finite(data) -> bool:
    if isinstance(data, torch.Tensor):
        return bool(torch.isfinite(data).all())
    return bool(np.isfinite(np.asarray(data)).all())


def check_dmd_results(fs: FieldSet, parsed_config: dict) -> bool:
    """Exact-config DMD match; a cached fit with non-finite amplitudes or
    eigenvalues is rejected, so a corrupt artifact is recomputed."""
    attrs = fs.attrs
    for key in ("amplitudes", "eigenvalues"):
        if key in fs.data_vars and not _all_finite(fs[key].data):
            return False
    return (
        era5_svd.check_svd_results(fs, parsed_config)
        and parsed_config["dmd_rank"] == attrs.get("dmd_rank")
        and int(parsed_config["optimized"]) == attrs.get("optimized")
        and parsed_config.get("bagging_trials", 0) == attrs.get("bagging_trials", 0)
        and parsed_config.get("forecast_steps", 0) == attrs.get("forecast_steps", 0)
        and parsed_config.get("control_input", "none") == attrs.get("control_input", "none")
        and parsed_config.get("multiresolution_levels", 0)
        == attrs.get("multiresolution_levels", 0)
        and (
            parsed_config.get("multiresolution_levels", 0) == 0
            or (
                parsed_config.get("mr_max_cycles", 1.0) == attrs.get("mr_max_cycles", 1.0)
                and parsed_config.get("mr_refit_rank", 0) == attrs.get("mr_refit_rank", 0)
            )
        )
    )


def retrieve_dmd_results(
    parsed_config: dict, use_store: bool = False
) -> tuple[FieldSet | None, bool]:
    return era5_svd._retrieve(
        parsed_config, use_store, "era5_dmd_path", "era5_dmd", check_dmd_results, "DMD results"
    )


def _hours_since_start(times: np.ndarray) -> np.ndarray:
    t64 = times.astype("datetime64[ns]").astype(np.int64)
    return ((t64 - t64[0]) / 3.6e12).astype(np.float32)


def _control_series(control_input: str, times: np.ndarray) -> np.ndarray:
    """The (q, T-1) control series of DMDc, u_k acting on x_k -> x_{k+1}.

    ``diurnal`` and ``seasonal``: the [cos, sin] pair at 24 h or the
    tropical year, at the transition times in absolute hours since the
    epoch (a real clock, not the window's start).  A path: a ``.npy``
    file, or an ``.h5`` / ``.hdf5`` file with a ``control`` dataset
    (h5py imported here), shaped (q, T-1), (q, T) (the last column
    dropped) or 1-D of either length.
    """
    n_expected = len(times) - 1
    if control_input in ("diurnal", "seasonal"):
        period = 24.0 if control_input == "diurnal" else 24.0 * 365.2422
        t64 = times.astype("datetime64[ns]").astype(np.int64)
        ang = 2.0 * np.pi * (t64[:-1] / 3.6e12).astype(np.float64) / period
        return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    if control_input.endswith(".npy"):
        series = np.load(control_input)
    else:
        import h5py

        with h5py.File(control_input, "r") as f:
            if "control" not in f:
                raise ValueError(f"control file {control_input} has no 'control' dataset")
            series = f["control"][:]
    series = np.asarray(series, dtype=np.float32)
    if series.ndim == 1:
        series = series[None, :]
    if series.shape[1] == n_expected + 1:
        series = series[:, :-1]
    if series.shape[1] != n_expected:
        raise ValueError(
            f"control series has {series.shape[1]} columns; need "
            f"{n_expected} (= T-1) or {n_expected + 1} (= T)"
        )
    return series


def _mr_refit_streamed(parsed_config: dict, dt_hours: float, mr_levels: int, mr_refit: int,
                       device: torch.device):
    """The raw-data mrDMD refit without X in the SVD artifact, out of core.

    The slice goes through the SVD stage's preprocessing again (variables,
    levels, resampling, the holdout withheld, rows flattened and
    standardized on ``device``), is packed to a ``.npy`` file beside the
    results as d delay slabs (the d-fold Hankel matrix never exists), and
    :func:`models.mrdmd.fit_mrdmd_streamed` fits the hierarchy from one
    Gram pass over it; the file is removed after.  The S-sized modes are
    formed only when they fit 2 GB; the time-side mode maps always are.
    """
    ds, _ = era5_svd.retrieve_era5_slice(parsed_config, use_store=False)
    if ds is None:
        raise ValueError(
            "mr_refit_rank needs either the data matrix in the SVD artifact "
            "(save_data_matrix = True) or the ERA5 slice artifact in the working "
            "directory for the streamed refit."
        )
    ds = ds[parsed_config["variables"]]
    ds = slice_era5_dataset(ds, levels=parsed_config["levels"])
    ds = resample_era5_dataset(ds, parsed_config["delta_time"])
    holdout = int(parsed_config.get("forecast_holdout", 0))
    if holdout > 0:
        ds = ds.isel(time=slice(0, len(ds.coord("time").values) - holdout))
    da_flat, _, _ = era5_svd._preprocess_on_device(ds, parsed_config, device)
    del ds
    d = int(parsed_config["delay_embedding"])
    packed = Path(str(parsed_config["save_path"]) + ".mr.packed.npy")
    save_packed_matrix(packed, da_flat.data, d=d)
    n_rows = da_flat.data.shape[0] * d
    del da_flat
    try:
        modes_bytes = n_rows * mr_refit * 8 * (2**mr_levels - 1)
        return fit_mrdmd_streamed(
            packed, dt=dt_hours, rank=mr_refit, max_levels=mr_levels,
            max_cycles=parsed_config.get("mr_max_cycles", 1.0),
            block_rows=int(parsed_config.get("stream_block_rows", 1 << 16)),
            return_modes=modes_bytes <= (2 << 30), device=device,
        )
    finally:
        packed.unlink(missing_ok=True)


def _mrdmd_fields(mr, space_coords: dict) -> dict[str, Field]:
    """Each level's fields: eigenvalues, amplitudes, the int8 slow and
    kept masks, the modes (tensors where they lie) and, on the Gram
    route, the time-side mode maps, on dims of their own (window_L<l>,
    mr_rank, mr_map_time)."""
    out: dict[str, Field] = {}
    mr_rank = Coord("mr_rank", np.arange(mr.levels[0].omega.shape[1]))
    for lv in mr.levels:
        win = f"window_L{lv.level}"
        coords = {win: Coord(win, np.arange(lv.omega.shape[0])), "mr_rank": mr_rank}

        def add(name, data, dims, attrs=None, extra=None):
            key = f"{name}_L{lv.level}"
            out[key] = Field(data, dims, {**coords, **(extra or {})}, attrs, name=key)

        add("mr_eigenvalues", lv.omega, (win, "mr_rank"), {"units": "1/hour (continuous time)"})
        add("mr_amplitudes", lv.amplitudes, (win, "mr_rank"))
        add("mr_slow_mask", lv.slow_mask.astype(np.int8), (win, "mr_rank"),
            {"description": "true |omega|<=rho criterion per level"})
        kept = lv.kept_mask if lv.kept_mask is not None else lv.slow_mask
        add("mr_kept_mask", kept.astype(np.int8), (win, "mr_rank"),
            {"description": "modes with amplitudes kept (all-True at the finest level, "
                            "which absorbs the remainder)"})
        if lv.modes is not None:
            add("mr_modes", lv.modes, (win, "space", "mr_rank"),
                extra={"space": space_coords["space"]})
        if lv.mode_map is not None:
            add("mr_mode_map", lv.mode_map, (win, "mr_map_time", "mr_rank"),
                {"description": "time-side mode factors: modes = X[:, :mr_t_used] @ map "
                                "(unit columns)"},
                extra={"mr_map_time": Coord("mr_map_time", np.arange(mr.t_used))})
    return out


def _mrdmd(factors, svd_results: FieldSet, parsed_config: dict, dt_hours: float,
           device: torch.device, space_coords: dict) -> tuple[dict, dict]:
    """The mrDMD hierarchy beside the main fit: in the POD subspace at
    ``dmd_rank`` (``factors`` = (U, s, V)), or with ``mr_refit_rank > 0``
    refit on the raw embedded matrix (``factors`` None): the artifact's X
    on ``device``, else streamed from the slice artifact.  Returns the
    fields and the attrs (the residual's share of the data's norm, the
    refit rank, the slow budget, T_used)."""
    mr_levels = int(parsed_config["multiresolution_levels"])
    mr_refit = int(parsed_config.get("mr_refit_rank", 0))
    max_cycles = parsed_config.get("mr_max_cycles", 1.0)
    if mr_refit > 0 and "X" in svd_results.data_vars:
        log_and_print(_logger(), f"Fitting {mr_levels}-level multiresolution DMD "
                                 f"(raw-data refit at rank {mr_refit})...")
        x_raw = era5_svd._as_tensor(svd_results["X"].data, device)
        mr = fit_mrdmd(x_raw, dt=dt_hours, rank=mr_refit, max_levels=mr_levels,
                       max_cycles=max_cycles)
        ref_norm = _fro(x_raw[:, : mr.t_used])
        del x_raw
    elif mr_refit > 0:
        log_and_print(_logger(), f"Fitting {mr_levels}-level multiresolution DMD (streamed raw "
                                 f"refit at rank {mr_refit}; no X in artifact)...")
        mr = _mr_refit_streamed(parsed_config, dt_hours, mr_levels, mr_refit, device)
        ref_norm = mr.x_fro
    else:
        log_and_print(_logger(), f"Fitting {mr_levels}-level multiresolution DMD...")
        u, s, v = factors
        mr = mrdmd_from_svd(u, s, v, dt=dt_hours, rank=parsed_config["dmd_rank"],
                            max_levels=mr_levels, max_cycles=max_cycles)
        ref_norm = float(torch.linalg.vector_norm(s[:, None] * v[:, : mr.t_used]))
    attrs = {
        "multiresolution_residual": float(mr.residual_fro / max(ref_norm, 1e-30)),
        "mr_refit_rank": mr_refit,
        "mr_max_cycles": float(max_cycles),
        "mr_t_used": int(mr.t_used),
    }
    return _mrdmd_fields(mr, space_coords), attrs


def _dmdc(factors, times: np.ndarray, dt_hours: float, parsed_config: dict,
          rank_coord: Coord, space_coords: dict, mesh=None) -> tuple[dict, dict]:
    """The DMDc fit beside the main fit, on the SVD factors under the
    configured control series (its SVDs over the ``mesh``'s ``space``
    axis where one is given).  Returns its fields (the continuous-time
    eigenvalues, the modes where they lie, the reduced operators and the
    series) and attrs."""
    control_input = parsed_config["control_input"]
    rank = parsed_config["dmd_rank"]
    u_ctrl = _control_series(control_input, times)  # (q, T-1)
    q_ctrl = u_ctrl.shape[0]
    log_and_print(_logger(), f"Fitting DMDc (control='{control_input}', q={q_ctrl}) "
                             f"at rank {rank}...")
    res = dmdc_from_svd(*factors, u_ctrl, rank=rank,
                        rank_omega=parsed_config.get("dmdc_rank_omega"), dt=dt_hours, mesh=mesh)
    ctrl_coord = Coord("control", np.arange(q_ctrl))
    rank_in = Coord("rank_in", np.arange(rank))
    fields = {
        "dmdc_eigenvalues": Field(res.omega.cpu().numpy(), ("rank",), {"rank": rank_coord},
                                  {"units": "1/hour (continuous time)"}, name="dmdc_eigenvalues"),
        "dmdc_modes": Field(res.modes, ("space", "rank"), space_coords, name="dmdc_modes"),
        "dmdc_a_red": Field(res.a_red.cpu().numpy(), ("rank", "rank_in"),
                            {"rank": rank_coord, "rank_in": rank_in},
                            {"description": "reduced unforced operator U^T A U"},
                            name="dmdc_a_red"),
        "dmdc_b_red": Field(res.b_red.cpu().numpy(), ("rank", "control"),
                            {"rank": rank_coord, "control": ctrl_coord},
                            {"description": "reduced input map U^T B"}, name="dmdc_b_red"),
        "dmdc_control": Field(u_ctrl, ("control", "time_ctrl"),
                              {"control": ctrl_coord,
                               "time_ctrl": Coord("time_ctrl", times[:-1])},
                              {"description": f"control series used ({control_input})"},
                              name="dmdc_control"),
    }
    log_and_print(_logger(), f"DMDc fit complete: one-step residual {res.residual:.3e}.")
    return fields, {"control_input": control_input, "dmdc_residual": float(res.residual)}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _svd_factors(svd_results: FieldSet, device: torch.device):
    """U, s and V as f32 tensors on ``device``: host arrays copied there
    once, tensors already there used where they lie."""
    return tuple(era5_svd._as_tensor(svd_results[name].data, device) for name in ("U", "s", "V"))


def _statistics(svd_results: FieldSet):
    """The (S*d,) X_mean and X_std of the SVD artifact, None where absent."""
    return tuple(
        svd_results[name].data if name in svd_results else None for name in ("X_mean", "X_std")
    )


def _holdout_scores(result, svd_results: FieldSet, t_hours: np.ndarray, holdout: int,
                    delay: int) -> dict:
    """Score the rollout at the ``holdout`` leads past the train window
    against the raw withheld truth, and the persistence baseline (the
    last raw train snapshot) the same way: latitude-weighted RMSE, ACC
    and bias per lead, as the artifact's attrs.  Both stream in row
    blocks: truth and persistence rows are moved to the device beside
    the forecast blocks, and the persistence row repeats over the leads
    there."""
    truth_field = svd_results["holdout_truth"]
    truth = truth_field.data  # (S, h) raw
    persist = svd_results["holdout_persistence"].data  # (S,) raw
    dt_hours = float(t_hours[1] - t_hours[0]) if len(t_hours) > 1 else 1.0
    t_lead = (t_hours[-1] + dt_hours * np.arange(1, holdout + 1)).astype(np.float32)
    mean, std = _statistics(svd_results)
    lat_rows = truth_field.coords["latitude_out"].values
    scores = streamed_forecast_scores(
        result, t_lead, truth, latitudes=lat_rows, mean=mean, std=std, delay=delay,
    )
    device = result.modes.device
    n_rows = truth.shape[0]
    w_rows = _space_weights(lat_rows, n_rows, device)
    acc_p = ScoreAccumulator()
    blk_p = max(4096, (1 << 26) // max(holdout, 1))
    for s0 in range(0, n_rows, blk_p):
        s1 = min(s0 + blk_p, n_rows)
        acc_p.update(
            era5_svd._as_tensor(persist[s0:s1], device)[:, None].expand(-1, holdout),
            era5_svd._as_tensor(truth[s0:s1], device),
            w_rows[s0:s1],
        )
    persist_scores = acc_p.finalize()
    attrs: dict = {"forecast_holdout": holdout}
    for key in ("rmse", "acc", "bias"):
        attrs[f"forecast_{key}"] = [float(x) for x in scores[key]]
        attrs[f"persistence_{key}"] = [float(x) for x in persist_scores[key]]
    log_and_print(
        _logger(),
        f"Holdout verification over {holdout} leads: RMSE {scores['rmse'][0]:.3f} -> "
        f"{scores['rmse'][-1]:.3f} (persistence {persist_scores['rmse'][0]:.3f} -> "
        f"{persist_scores['rmse'][-1]:.3f}), "
        f"ACC {scores['acc'][0]:.3f} -> {scores['acc'][-1]:.3f}.",
    )
    return attrs


def _forecast_field(result, svd_results: FieldSet, u_field: Field, times: np.ndarray,
                    t_hours: np.ndarray, n_future: int, delay: int) -> Field:
    """The physical-unit forecast of the undelayed rows over the training
    window and ``n_future`` steps past it, (S, T + F) f32 on the modes'
    device, filled block by block (the dense (S*d, T + F) rollout is
    never formed), on its own ``space_out`` / ``time_out`` axes."""
    dt_hours = float(t_hours[1] - t_hours[0]) if len(t_hours) > 1 else 1.0
    t_all = np.concatenate(
        [t_hours, t_hours[-1] + dt_hours * np.arange(1, n_future + 1)]
    ).astype(np.float32)
    mean, std = _statistics(svd_results)
    n_space = result.modes.shape[0] // delay
    fields = torch.empty((n_space, len(t_all)), dtype=torch.float32, device=result.modes.device)
    for s0, blk in iter_forecast_blocks(result, t_all, mean, std, delay=delay):
        fields[s0 : s0 + blk.shape[0]] = blk
    delta = times[1] - times[0] if len(times) > 1 else np.timedelta64(1, "h")
    times_all = np.concatenate([times, times[-1] + delta * np.arange(1, n_future + 1)])
    # the undelayed rows are the last n_space of the embedded space axis:
    # views of U's row coordinates, not copies
    forecast_coords = {
        "space_out": Coord("space_out", u_field.coords["space"].values[-n_space:]),
        "time_out": Coord("time_out", times_all),
    }
    for extra in ("original_variable", "level", "latitude", "longitude"):
        if extra in u_field.coords:
            forecast_coords[f"{extra}_out"] = Coord(
                "space_out", u_field.coords[extra].values[-n_space:]
            )
    return Field(fields, ("space_out", "time_out"), forecast_coords, name="forecast")


def fit_dmd_from_svd_results(
    svd_results: FieldSet,
    parsed_config: dict,
    mesh=None,
    device: torch.device | str | None = None,
) -> FieldSet:
    """Fit (opt)DMD on the SVD factors and package the results.

    ``device``: where the fit runs, the card unless given, or unless U
    is a tensor on another device; on a ``mesh`` its device.  ``mesh``:
    the bag over its ``data`` axis and DMDc's SVDs over its ``space``
    axis (module docstring); every rank of the mesh calls this with the
    whole results.  Returns a FieldSet of the JAX stage's schema whose
    S-sized fields (``modes``, ``modes_std``, ``mr_modes_L*``,
    ``dmdc_modes``, ``forecast``) are tensors on that device.
    """
    u_field = svd_results["U"]
    device = mesh.device if mesh is not None else era5_svd._device(device, u_field)
    u, s, v = _svd_factors(svd_results, device)
    times = np.asarray(svd_results["V"].coords["time"].values)
    t_hours = _hours_since_start(times)
    t_fit = torch.from_numpy(t_hours).to(device)

    rank = parsed_config["dmd_rank"]
    max_iter = parsed_config["lm_max_iter"] if parsed_config["optimized"] else 0
    n_trials = int(parsed_config.get("bagging_trials", 0))
    kind = (
        f"bagged optimized ({n_trials} trials)"
        if n_trials
        else ("optimized" if parsed_config["optimized"] else "exact")
    )
    log_and_print(_logger(), f"Fitting {kind} DMD at rank {rank} on {device}...")
    _synchronize(device)
    t_start = time.perf_counter()
    bop = None
    if n_trials:
        bop = bopdmd_from_svd(
            u, s, v, t_fit, rank=rank, n_trials=n_trials,
            trial_fraction=parsed_config.get("bagging_fraction", 0.8), max_iter=max_iter,
            mesh=mesh,
        )
        # point estimates for packaging and rollout: the trial means; the
        # full-data fit gives the residual and iteration diagnostics
        result = bop.full._replace(alpha=bop.eigenvalues, modes=bop.modes,
                                   amplitudes=bop.amplitudes)
    else:
        result = optdmd_from_svd(u, s, v, t_fit, rank=rank, max_iter=max_iter)
    _synchronize(device)
    fit_seconds = time.perf_counter() - t_start
    factors = (u, s, v)
    del u, s, v
    log_and_print(
        _logger(),
        f"DMD fit complete: rel residual {float(result.residual):.3e}, "
        f"{int(result.n_iters)} LM iterations, {fit_seconds:.2f}s.",
    )

    rank_coord = Coord("rank", np.arange(rank))
    space_coords = {"space": u_field.coords["space"], "rank": rank_coord}
    for extra in ("original_variable", "delay", "level", "latitude", "longitude"):
        if extra in u_field.coords:
            space_coords[extra] = u_field.coords[extra]

    def small(name, data, attrs=None):
        return Field(data.cpu().numpy(), ("rank",), {"rank": rank_coord}, attrs, name=name)

    data_vars: dict[str, Field] = {
        "modes": Field(result.modes, ("space", "rank"), space_coords, name="modes"),
        "eigenvalues": small("eigenvalues", result.alpha, {"units": "1/hour (continuous time)"}),
        "amplitudes": small("amplitudes", result.amplitudes),
    }
    if bop is not None:
        # bagging uncertainties: per-quantity trial standard deviations
        data_vars["eigenvalues_std"] = small("eigenvalues_std", bop.eigenvalues_std,
                                             {"units": "1/hour (trial std)"})
        data_vars["amplitudes_std"] = small("amplitudes_std", bop.amplitudes_std)
        data_vars["modes_std"] = Field(bop.modes_std, ("space", "rank"), space_coords,
                                       name="modes_std")

    dt_hours = float(t_hours[1] - t_hours[0]) if len(t_hours) > 1 else 1.0
    control_input = parsed_config.get("control_input", "none")
    mr_levels = int(parsed_config.get("multiresolution_levels", 0))
    dmdc_fields, dmdc_attrs = {}, {}
    if control_input != "none":  # before a raw mrDMD refit, which frees U
        dmdc_fields, dmdc_attrs = _dmdc(factors, times, dt_hours, parsed_config, rank_coord,
                                        space_coords, mesh)
    if mr_levels == 0 or parsed_config.get("mr_refit_rank", 0) > 0:
        factors = None  # no fit below reads U
    attrs: dict = {}
    if mr_levels > 0:
        mr_fields, mr_attrs = _mrdmd(factors, svd_results, parsed_config, dt_hours, device,
                                     space_coords)
        data_vars.update(mr_fields)
        attrs.update(mr_attrs)
    factors = None
    data_vars.update(dmdc_fields)
    attrs.update(dmdc_attrs)

    d = int(parsed_config["delay_embedding"])
    # forecast verification on the withheld holdout window: the fit saw
    # only the train columns (the SVD stage withheld the tail, from the
    # standardization statistics too)
    holdout = int(parsed_config.get("forecast_holdout", 0))
    if holdout > 0 and "holdout_truth" in svd_results.data_vars:
        attrs.update(_holdout_scores(result, svd_results, t_hours, holdout, d))

    n_future = parsed_config["forecast_steps"]
    if n_future > 0:
        data_vars["forecast"] = _forecast_field(result, svd_results, u_field, times, t_hours,
                                                n_future, d)

    out = FieldSet(data_vars, attrs=dict(svd_results.attrs))
    out.attrs["dmd_rank"] = rank
    out.attrs["optimized"] = int(parsed_config["optimized"])
    out.attrs["bagging_trials"] = n_trials
    out.attrs["multiresolution_levels"] = mr_levels
    out.attrs["control_input"] = control_input
    out.attrs.update(attrs)
    if bop is not None:
        # diverged trials are dropped by the bag; record the survivors
        out.attrs["bagging_trials_used"] = int(len(bop.trial_eigenvalues))
    out.attrs["forecast_steps"] = n_future
    out.attrs["dmd_residual"] = float(result.residual)
    out.attrs["lm_iterations"] = int(result.n_iters)
    out.attrs["dmd_seconds"] = round(fit_seconds, 4)
    out.attrs["date_processed"] = datetime.now().isoformat()
    return out


def main(
    config: dict | None = None,
    write_artifact: bool = False,
    use_store: bool = False,
    mesh=None,
    device: torch.device | str | None = None,
) -> tuple[FieldSet, bool, bool]:
    """DMD stage orchestration: the cached results if the workdir or the
    store holds a match, else ``era5_svd.main`` (its own cache ladder)
    and :func:`fit_dmd_from_svd_results`, then (with ``write_artifact``)
    the artifact written and (with ``use_store``) versioned.

    Returns (dmd_results, added_to_store, retrieved_from_store).
    ``device``: where a computation runs, the card unless given;
    ``mesh``: the SVD stage's mesh and the fit's (module docstring;
    without one the SVD stage takes its default mesh over the world and
    the fit runs on one device).  Every rank of the world calls it; in a
    world of several ranks rank 0 alone writes and versions the
    artifact (``era5_svd._on_rank0``: the others wait for its outcome
    and raise with it if it failed).
    """
    if config is None:
        config = config_reader("era5-dmd")
    logger = _logger()
    added_to_store = False
    parsed_config = config_parser(config, "era5-dmd")

    try:
        dmd_results, retrieved_from_store = retrieve_dmd_results(parsed_config, use_store)
    except Exception as err:
        msg = f"Error retrieving DMD results: {err}"
        log_and_print(logger, msg, "error")
        raise Exception(msg) from err

    if dmd_results is None:
        try:
            svd_results, _, _ = era5_svd.main(
                config, write_artifact=write_artifact, use_store=use_store, device=device,
                mesh=mesh,
            )
        except Exception as err:
            msg = f"Error obtaining SVD results for DMD: {err}"
            log_and_print(logger, msg, "error")
            raise Exception(msg) from err

        try:
            dmd_results = fit_dmd_from_svd_results(svd_results, parsed_config, mesh=mesh,
                                                   device=device)
        except Exception as err:
            msg = f"Error in the DMD fit: {err}"
            log_and_print(logger, msg, "error")
            raise Exception(msg) from err

        if write_artifact:
            added_to_store = bool(era5_svd._on_rank0(
                lambda: era5_svd._write_results(dmd_results, parsed_config, use_store, logger,
                                                "DMD")))

    return dmd_results, added_to_store, retrieved_from_store


if __name__ == "__main__":
    main(write_artifact=True, use_store=True)
