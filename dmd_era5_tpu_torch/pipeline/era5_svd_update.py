"""Incremental decomposition stage: extend an SVD artifact.

PyTorch counterpart of ``dmd_era5_tpu/pipeline/era5_svd_update.py``,
the pipeline form of ``pipeline.incremental.update_svd_results``.
Config-driven like the other stages (it reads the ``era5-svd`` section):

1. retrieve the existing SVD artifact (workdir, then the store, as
   ``pipeline.era5_svd`` does, then the newest artifact of the same
   source, variables, levels and preprocessing in the store, whatever
   its time range);
2. retrieve the ERA5 slice of the extended window;
3. :func:`update_from_slice`: select, slice and resample it, keep the
   strictly new snapshots plus the d-1 boundary ones the delay embedding
   needs, and rank-update the factorization on the card with the
   original window's statistics (the history is never refactored);
4. write and version the result.

Run as ``python -m dmd_era5_tpu_torch.pipeline.era5_svd_update``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dmd_era5_tpu_torch.core import config_parser, config_reader
from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.pipeline.artifacts import add_data_to_store, retrieve_latest_from_store
from dmd_era5_tpu_torch.pipeline.era5_svd import retrieve_era5_slice, retrieve_svd_results
from dmd_era5_tpu_torch.pipeline.incremental import update_svd_results
from dmd_era5_tpu_torch.snapmat.slicing import resample_era5_dataset, slice_era5_dataset
from dmd_era5_tpu_torch.utils.io_h5 import load_fieldset, save_fieldset
from dmd_era5_tpu_torch.utils.labels import FieldSet

__all__ = ["select_new_snapshots", "update_from_slice", "main"]


@functools.cache
def _logger():
    return setup_logger("ERA5-SVD-Update-torch", "era5_svd_update_torch.log")


def select_new_snapshots(era5_slice: FieldSet, svd_results: FieldSet) -> FieldSet | None:
    """Columns of the slice not yet in the artifact, plus the d-1
    boundary snapshots the delay embedding needs
    (``dmd_era5_tpu/pipeline/era5_svd_update.py:49``).

    The artifact's V carries the embedded window's timestamps; a window
    that straddles the old boundary ends strictly after it, so the raw
    columns start d-1 samples before the first new one.  Returns None
    when the slice adds nothing.
    """
    d = int(svd_results.attrs["delay_embedding"])
    covered = np.asarray(svd_results["V"].coords["time"].values, dtype="datetime64[ns]")
    times = np.asarray(era5_slice.coord("time").values, dtype="datetime64[ns]")
    n_new = int(np.sum(times > covered[-1]))
    if n_new == 0:
        return None
    first = len(times) - n_new - (d - 1)
    if first < 0:
        raise ValueError(
            "ERA5 slice does not contain the d-1 boundary snapshots "
            f"before {times[len(times) - n_new]} (need {d - 1})."
        )
    return era5_slice.isel(time=slice(first, len(times)))


def update_from_slice(
    svd_results: FieldSet,
    era5_slice: FieldSet,
    parsed_config: dict,
    device: torch.device | str | None = None,
) -> FieldSet | None:
    """The stage's compute body: the slice's configured variables,
    levels and time step, its new snapshots (:func:`select_new_snapshots`)
    and the rank update (``update_svd_results`` on ``device``, the card
    unless given).  Standardization is not redone: the new columns take
    the artifact's X_mean / X_std.  Returns None when the artifact
    already covers the slice."""
    ds = era5_slice[parsed_config["variables"]]
    ds = slice_era5_dataset(ds, levels=parsed_config["levels"])
    ds = resample_era5_dataset(ds, parsed_config["delta_time"])
    new_slice = select_new_snapshots(ds, svd_results)
    if new_slice is None:
        return None
    return update_svd_results(svd_results, new_slice,
                              n_components=parsed_config["n_components"], device=device)


def main(
    config: dict | None = None,
    write_artifact: bool = False,
    use_store: bool = False,
    device: torch.device | str | None = None,
) -> tuple[FieldSet, bool, bool]:
    """Incremental-update orchestration
    (``dmd_era5_tpu/pipeline/era5_svd_update.py:79``).

    Returns (svd_results, added_to_store, updated): ``updated`` False
    means the artifact already covered the requested window.
    ``device``: where the update runs, the card unless given.
    """
    if config is None:
        config = config_reader("era5-svd")
    logger = _logger()
    parsed_config = config_parser(config, "era5-svd")
    added_to_store = False

    svd_results, _ = retrieve_svd_results(parsed_config, use_store)
    if svd_results is None and use_store:
        # the extended window's derived filename differs from the base
        # window's, so the per-path ladder misses: take the newest artifact
        # of the same source, variables, levels and preprocessing
        try:
            path = retrieve_latest_from_store(parsed_config, "era5_svd")
            svd_results = load_fieldset(path)
            log_and_print(logger, f"Base artifact for the update: {path}")
        except (ValueError, FileNotFoundError) as err:
            log_and_print(logger, f"Store scan found no base artifact: {err}", "warning")
    if svd_results is None:
        msg = (
            "No existing SVD artifact to update — run pipeline.era5_svd "
            "first (incremental updates extend a previous window)."
        )
        log_and_print(logger, msg, "error")
        raise FileNotFoundError(msg)

    era5_slice, _ = retrieve_era5_slice(parsed_config, use_store)
    if era5_slice is None:
        msg = "Could not retrieve the ERA5 slice for the extended window."
        log_and_print(logger, msg, "error")
        raise FileNotFoundError(msg)

    updated = update_from_slice(svd_results, era5_slice, parsed_config, device=device)
    if updated is None:
        log_and_print(logger, "Artifact already covers the requested window; nothing to do.")
        return svd_results, False, False

    if write_artifact:
        save_fieldset(updated, parsed_config["save_path"])
        log_and_print(logger, f"Updated SVD results written to {parsed_config['save_path']}")
        if use_store:
            add_data_to_store(parsed_config["save_path"], updated.attrs)
            added_to_store = True
            log_and_print(logger, "Updated SVD results versioned.")
    return updated, added_to_store, True


if __name__ == "__main__":
    main(write_artifact=True, use_store=True)
