"""Ingest stage: ERA5 slice acquisition.

The port's counterpart of ``dmd_era5_tpu/pipeline/era5_download.py``:
retrieve from the store or acquire (the mock backend, a local HDF5
source, or a Zarr store: a local directory or a ``gs://`` URL, read with
slice pushdown by ``snapmat/era5_zarr.py``), slice by time and levels,
resample when delta > 1h, stamp config attributes, persist, version.
Host numpy throughout.

Run as ``python -m dmd_era5_tpu_torch.pipeline.era5_download``.
"""

from __future__ import annotations

import functools
import os
import time
from datetime import datetime, timedelta

import numpy as np

from dmd_era5_tpu_torch.core import config_parser, config_reader, log_and_print, setup_logger
from dmd_era5_tpu_torch.pipeline.artifacts import add_data_to_store, retrieve_data_from_store
from dmd_era5_tpu_torch.snapmat.mock import create_mock_era5
from dmd_era5_tpu_torch.snapmat.slicing import resample_era5_dataset, slice_era5_dataset
from dmd_era5_tpu_torch.utils.io_h5 import load_fieldset, save_fieldset
from dmd_era5_tpu_torch.utils.labels import FieldSet

__all__ = ["add_config_attributes", "download_era5_data", "main"]


@functools.cache
def _logger():
    return setup_logger("ERA5Download-torch", "era5_download_torch.log")


def add_config_attributes(fs: FieldSet, parsed_config: dict) -> FieldSet:
    """Stamp provenance attributes."""
    fs.attrs["source_path"] = parsed_config["source_path"]
    fs.attrs["start_datetime"] = parsed_config["start_datetime"].isoformat()
    fs.attrs["end_datetime"] = parsed_config["end_datetime"].isoformat()
    fs.attrs["hours_delta_time"] = parsed_config["delta_time"].total_seconds() / 3600
    fs.attrs["variables"] = list(parsed_config["variables"])
    fs.attrs["levels"] = list(parsed_config["levels"])
    fs.attrs["date_downloaded"] = datetime.now().isoformat()
    return fs


def _open_remote_era5(parsed_config: dict) -> FieldSet:
    """The window's variables and levels from an ERA5 Zarr store (a local
    directory or an fsspec URL such as ARCO-ERA5's ``gs://`` store):
    only the chunks covering them are read."""
    from dmd_era5_tpu_torch.snapmat.era5_zarr import read_era5_zarr_slice

    return read_era5_zarr_slice(
        parsed_config["source_path"],
        parsed_config["variables"],
        parsed_config["start_datetime"],
        parsed_config["end_datetime"],
        parsed_config["levels"],
    )


def download_era5_data(parsed_config: dict, use_mock_data: bool = False) -> FieldSet:
    """Acquire, slice, resample, stamp, and persist an ERA5 slice.

    Mock data is never written to disk here and rewrites source_path to
    "mock_data"; it is drawn from the global ``np.random`` state.  Emits
    ingest throughput counters into the artifact attrs
    (``download_seconds`` / ``download_melem_per_s``).
    """
    t_start = time.perf_counter()
    try:
        if use_mock_data:
            log_and_print(_logger(), "Creating mock ERA5 data...")
            full = create_mock_era5(
                start_datetime=parsed_config["start_datetime"],
                end_datetime=parsed_config["end_datetime"],
                variables=parsed_config["variables"],
                levels=parsed_config["levels"],
            )
            parsed_config["source_path"] = "mock_data"
            log_and_print(_logger(), "Mock ERA5 data created.")
        else:
            log_and_print(_logger(), "Loading ERA5 Dataset...")
            source = str(parsed_config["source_path"])
            if os.path.isfile(source):
                full = load_fieldset(source)  # a local HDF5 source
            else:
                full = _open_remote_era5(parsed_config)  # a Zarr store
            full = full[parsed_config["variables"]]

        log_and_print(_logger(), "Slicing ERA5 Dataset...")
        fs = slice_era5_dataset(
            full,
            parsed_config["start_datetime"],
            parsed_config["end_datetime"],
            parsed_config["levels"],
        )
        if parsed_config["delta_time"] > timedelta(hours=1):
            log_and_print(_logger(), "Resampling ERA5 Dataset in time...")
            fs = resample_era5_dataset(fs, parsed_config["delta_time"])

        fs = add_config_attributes(fs, parsed_config)
        elapsed = time.perf_counter() - t_start
        elements = sum(int(np.prod(f.shape)) for f in fs.data_vars.values())
        fs.attrs["download_seconds"] = round(elapsed, 4)
        fs.attrs["download_melem_per_s"] = round(elements / elapsed / 1e6, 4)
        log_and_print(
            _logger(),
            f"Ingest: {elements / 1e6:.2f} Melem in {elapsed:.2f}s "
            f"({elements / elapsed / 1e6:.1f} Melem/s).",
        )

        if not use_mock_data:
            log_and_print(_logger(), f"Saving ERA5 Dataset to {parsed_config['save_path']}...")
            save_fieldset(fs, parsed_config["save_path"])
            log_and_print(_logger(), "ERA5 Dataset saved.")
        return fs
    except Exception as err:
        verb = "creating mock" if use_mock_data else "downloading"
        msg = f"Error {verb} ERA5 Dataset: {err}"
        log_and_print(_logger(), msg, level="error")
        raise ValueError(msg) from err


def main(
    config: dict | None = None,
    use_mock_data: bool = False,
    use_store: bool = False,
) -> tuple[bool, bool]:
    """Retrieve-or-acquire orchestration.

    Returns (added_to_store, retrieved_from_store).  Errors are logged,
    not raised, as in the JAX stage.
    """
    if config is None:
        config = config_reader("era5-download")
    added_to_store = False
    retrieved_from_store = False
    try:
        parsed_config = config_parser(config, "era5-download", logger=_logger())

        def acquire_and_version() -> bool:
            fs = download_era5_data(parsed_config, use_mock_data)
            log_and_print(_logger(), "ERA5 download process completed successfully.")
            try:
                log_and_print(_logger(), "Versioning ERA5 slice...")
                if use_mock_data:
                    # mock data skips the disk write in download_era5_data;
                    # persist it here so it can be versioned
                    save_fieldset(fs, parsed_config["save_path"])
                add_data_to_store(parsed_config["save_path"], fs.attrs)
                log_and_print(_logger(), "ERA5 slice versioned.")
                return True
            except Exception as err:
                log_and_print(_logger(), f"Error versioning ERA5 slice: {err}", level="error")
                return False

        if use_store:
            log_and_print(_logger(), "Attempting to retrieve ERA5 slice from store...")
            try:
                retrieve_data_from_store(parsed_config, data_type="era5_slice")
                log_and_print(_logger(), f"ERA5 slice retrieved: {parsed_config['save_path']}")
                retrieved_from_store = True
            except (FileNotFoundError, ValueError) as err:
                log_and_print(
                    _logger(), f"Could not retrieve ERA5 slice from store: {err}", level="warning"
                )
                added_to_store = acquire_and_version()
        else:
            download_era5_data(parsed_config, use_mock_data)
            log_and_print(_logger(), "ERA5 download process completed successfully.")
    except ValueError as err:
        log_and_print(_logger(), f"Configuration error: {err}", level="error")
    except Exception as err:
        log_and_print(_logger(), f"ERA5 download process failed: {err}", level="error")

    return added_to_store, retrieved_from_store


if __name__ == "__main__":
    main(use_store=True)
