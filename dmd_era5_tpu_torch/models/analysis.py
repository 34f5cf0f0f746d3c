"""Spectral analysis of DMD fits in physical units.

PyTorch-package counterpart of ``dmd_era5_tpu/models/analysis.py``, a
copy of its host numpy: continuous-time eigenvalues as growth rates,
e-folding times, frequencies and periods in the sampling unit with an
energy ranking of the modes (:func:`mode_spectrum`), and the flat
spatial modes of a DMD stage FieldSet unflattened onto the (variable,
level, latitude, longitude) grid that the snapshot matrix was built from
(:func:`modes_to_grid`, one delay block).  Modes held as a tensor (the
port's stage leaves them on its device) are copied to the host first.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

__all__ = ["ModeSpectrum", "mode_spectrum", "modes_to_grid"]


class ModeSpectrum(NamedTuple):
    """Per-mode physical interpretation of continuous eigenvalues.

    With alpha in 1/<unit> (the stage fits in 1/hour), for mode j:
    growth_rate[j] = Re(alpha_j)            (1/unit; <0 decays)
    e_folding[j]   = -1/Re(alpha_j)         (unit; inf for neutral)
    frequency[j]   = Im(alpha_j) / (2 pi)   (cycles/unit; signed)
    period[j]      = 1/|frequency_j|        (unit; inf if non-oscillatory)
    energy[j]      = amplitude_j^2          (mode energy, for ranking)
    order          = mode indices sorted by descending energy
    """

    growth_rate: np.ndarray
    e_folding: np.ndarray
    frequency: np.ndarray
    period: np.ndarray
    energy: np.ndarray
    order: np.ndarray


def mode_spectrum(
    eigenvalues: np.ndarray, amplitudes: np.ndarray | None = None
) -> ModeSpectrum:
    """Physical-units view of a DMD spectrum.

    Args:
        eigenvalues: (r,) complex continuous-time eigenvalues (1/unit).
        amplitudes: optional (r,) real mode amplitudes for the energy
            ranking (defaults to ones — ``order`` is then the identity
            up to stable sorting).
    """
    alpha = np.asarray(eigenvalues, dtype=np.complex64)
    growth = alpha.real.astype(np.float32)
    with np.errstate(divide="ignore"):
        e_fold = np.where(
            growth != 0, -1.0 / np.where(growth == 0, 1.0, growth), np.inf
        ).astype(np.float32)
    freq = (alpha.imag / (2.0 * np.pi)).astype(np.float32)
    with np.errstate(divide="ignore"):
        period = np.where(
            freq != 0, 1.0 / np.abs(np.where(freq == 0, 1.0, freq)), np.inf
        ).astype(np.float32)
    amps = (
        np.ones(alpha.shape[0], np.float32)
        if amplitudes is None
        else np.asarray(amplitudes, dtype=np.float32)
    )
    energy = amps * amps
    order = np.argsort(-energy, kind="stable")
    return ModeSpectrum(growth, e_fold, freq, period, energy, order)


def modes_to_grid(results: FieldSet, delay_block: int = 0) -> FieldSet:
    """Unflatten DMD modes onto the (variable, level, lat, lon) grid.

    Inverts the snapshot-matrix stacking — space = (level, lat, lon)
    innermost-last (reference slice_tools.py:311), variables
    concatenated along space (:336), delay blocks tiled outermost
    (:255-274) — for ONE delay block (default 0 = the undelayed rows,
    matching the forecast's output rows).

    Args:
        results: a DMD-stage FieldSet with ``modes`` (space, rank) and
            the stacked space coords (``original_variable`` + tuple or
            level/latitude/longitude coords).

    Returns a FieldSet with one complex Field per variable, dims
    (level, latitude, longitude, rank), plus passthrough attrs.
    """
    modes = results["modes"]
    values = modes.data
    values = values.cpu().numpy() if isinstance(values, torch.Tensor) else np.asarray(values)
    n_rank = values.shape[1]
    variables = np.asarray(modes.coords["original_variable"].values)
    # space location per row: either the stacked tuple coord, or the
    # parallel level/latitude/longitude coords the stage writes after
    # space_coord_to_level_lat_lon (NetCDF-serializable form)
    if all(c in modes.coords for c in ("level", "latitude", "longitude")):
        space_vals = np.stack(
            [
                np.asarray(modes.coords["level"].values, dtype=np.float64),
                np.asarray(modes.coords["latitude"].values, dtype=np.float64),
                np.asarray(modes.coords["longitude"].values, dtype=np.float64),
            ],
            axis=1,
        )
    else:
        space_vals = np.asarray(
            [tuple(s) for s in modes.coords["space"].values],
            dtype=np.float64,
        )
    if "delay" in modes.coords:
        dsel = np.asarray(modes.coords["delay"].values) == delay_block
        if not dsel.any():
            raise ValueError(f"delay block {delay_block} not present")
        values = values[dsel]
        variables = variables[dsel]
        space_vals = space_vals[dsel]

    out: dict[str, Field] = {}
    for var in dict.fromkeys(variables.tolist()):  # preserve order
        vsel = variables == var
        vvals = values[vsel]
        vspace = space_vals[vsel]
        # stacked (level, lat, lon) rows, level-major then lat then lon
        tup = vspace
        n_l = len(dict.fromkeys(tup[:, 0].tolist()))
        n_a = len(dict.fromkeys(tup[:, 1].tolist()))
        n_o = len(dict.fromkeys(tup[:, 2].tolist()))
        if n_l * n_a * n_o != vvals.shape[0]:
            raise ValueError(
                f"{var}: space rows {vvals.shape[0]} != "
                f"{n_l}x{n_a}x{n_o} grid"
            )
        # axis values in ORDER OF APPEARANCE (the file's grid order —
        # e.g. latitude runs 90 -> -90 in ERA5); rows are already in
        # stack order so the reshape is a view
        levels = tup[:: n_a * n_o, 0]
        lats = tup[: n_a * n_o : n_o, 1]
        lons = tup[:n_o, 2]
        grid = vvals.reshape(n_l, n_a, n_o, n_rank)
        out[str(var)] = Field(
            grid,
            ("level", "latitude", "longitude", "rank"),
            {
                "level": _coord("level", levels),
                "latitude": _coord("latitude", lats),
                "longitude": _coord("longitude", lons),
                "rank": _coord("rank", np.arange(n_rank)),
            },
            name=str(var),
        )
    return FieldSet(out, attrs=dict(results.attrs))


def _coord(dim: str, values: np.ndarray) -> Coord:
    return Coord(dim, values)
