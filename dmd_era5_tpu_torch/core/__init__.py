"""Core facade: config, constants, logging, paths.

The port's own copy of ``dmd_era5_tpu/core``, host-only Python: the SVD
stage's dispatcher reads its configuration through it.
"""

from dmd_era5_tpu_torch.core.config_parser import config_parser, validate_time_parameters
from dmd_era5_tpu_torch.core.config_reader import config_reader
from dmd_era5_tpu_torch.core.constants import (
    ERA5_PRESSURE_LEVEL_VARIABLES,
    ERA5_PRESSURE_LEVELS,
    ERA5_SINGLE_LEVEL_VARIABLES,
    ERA5_VARIABLES,
)
from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.core.paths import data_dir, logs_dir, repo_root

__all__ = [
    "config_parser",
    "config_reader",
    "validate_time_parameters",
    "setup_logger",
    "log_and_print",
    "repo_root",
    "data_dir",
    "logs_dir",
    "ERA5_PRESSURE_LEVEL_VARIABLES",
    "ERA5_SINGLE_LEVEL_VARIABLES",
    "ERA5_VARIABLES",
    "ERA5_PRESSURE_LEVELS",
]
