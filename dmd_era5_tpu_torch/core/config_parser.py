"""Config validation and normalization.

The port's copy of ``dmd_era5_tpu/core/config_parser.py``, which must
give the same dict for every section and raise the same exceptions: the
three sections, required-field checks, ISO-8601 datetimes, the
``h/d/w/m/y`` delta-time grammar, time-range sanity checks (including
no-future-start), variable/level whitelist expansion, derived artifact
names (``.h5``), the SVD- and DMD-specific parameter checks, and the
optional execution fields (``precision``, ``mesh_shape``,
``dcn_mesh_shape``) with their defaults.
"""

from __future__ import annotations

import os
from datetime import datetime, timedelta
from logging import Logger

from dmd_era5_tpu_torch.core.constants import (
    ERA5_PRESSURE_LEVEL_VARIABLES,
    ERA5_PRESSURE_LEVELS,
    ERA5_SINGLE_LEVEL_VARIABLES,
)
from dmd_era5_tpu_torch.core.paths import repo_root

SUPPORTED_SECTIONS = ("era5-download", "era5-svd", "era5-dmd")

_COMMON_REQUIRED = (
    "source_path",
    "start_datetime",
    "end_datetime",
    "delta_time",
    "variables",
    "levels",
)

_SVD_REQUIRED = _COMMON_REQUIRED + (
    "svd_type",
    "delay_embedding",
    "mean_center",
    "scale",
    "n_components",
    "save_data_matrix",
)

# The DMD stage consumes
# SVD artifacts, so it needs the full SVD config to locate them, plus
# its own solver fields.
_DMD_REQUIRED = _SVD_REQUIRED + ("dmd_rank", "optimized")

SUPPORTED_SVD_TYPES = ("standard", "randomized")
SUPPORTED_PRECISIONS = ("float32", "bfloat16")

# Decomposition execution backends (pipeline/era5_svd.py::svd_on_era5;
# the port runs inmem, hankel and streamed on one device so far):
#   auto     - pick per config/mesh (hankel operators for d>1 randomized,
#              grid2d on a time-sharded mesh, else inmem)
#   inmem    - materialized (embedded) matrix, row-sharded over space
#   hankel   - delay-embedding as operators; H_d(X) never materialized
#   grid2d   - (space x time) grid-sharded randomized SVD
#   streamed - out-of-core: packed artifact streamed disk->device
#   onepass  - out-of-core, single disk pass (two-sided sketch)
SUPPORTED_SVD_BACKENDS = (
    "auto",
    "inmem",
    "hankel",
    "grid2d",
    "streamed",
    "onepass",
)

# Backends that only exist for the sketch-based decomposition.
# hankel serves both svd_types: randomized (sketch) and standard (the
# exact banded-Gram path, ops/hankel.py::hankel_exact_svd)
# streamed serves BOTH svd_types since round 5: standard takes the
# 2-pass out-of-core exact Gram route (streamed_exact_gram_svd)
_RANDOMIZED_ONLY_BACKENDS = ("grid2d", "onepass")

# Delta-time grammar: suffix unit -> timedelta factory, including the
# month approximation of 365//12 days.
_DELTA_UNITS = {
    "h": lambda n: timedelta(hours=n),
    "d": lambda n: timedelta(days=n),
    "w": lambda n: timedelta(weeks=n),
    "m": lambda n: timedelta(days=n * 365 // 12),
    "y": lambda n: timedelta(days=n * 365),
}


def _fail(msg: str, logger: Logger | None) -> None:
    if logger is not None:
        logger.error(msg)
    raise ValueError(msg)


def validate_time_parameters(parsed: dict) -> None:
    """Sanity-check start/end/delta relationships.

    End after start, range at least one delta long, positive delta, and
    a start datetime that is not in the future.
    """
    start: datetime = parsed["start_datetime"]
    end: datetime = parsed["end_datetime"]
    delta: timedelta = parsed["delta_time"]

    if end <= start:
        raise ValueError("End datetime must be after start datetime")
    if (end - start) < delta:
        raise ValueError(
            f"Time range must be at least as long as delta_time. "
            f"{end} - {start} < {delta}"
        )
    if delta <= timedelta(0):
        raise ValueError("delta_time must be positive.")
    if start > datetime.now():
        raise ValueError("Start date cannot be in the future.")


def _parse_datetimes(config: dict, parsed: dict, logger: Logger | None) -> None:
    try:
        parsed["start_datetime"] = datetime.fromisoformat(config["start_datetime"])
        parsed["end_datetime"] = datetime.fromisoformat(config["end_datetime"])
    except (ValueError, TypeError) as err:
        _fail(f"Invalid datetime format in config: {err}", logger)


def _parse_delta_time(config: dict, parsed: dict, logger: Logger | None) -> None:
    spec = config["delta_time"]
    try:
        unit = spec[-1].lower()
        count = int(spec[:-1])
    except (ValueError, TypeError, IndexError) as err:
        _fail(f"Error parsing delta_time from config: {err}", logger)
        return
    factory = _DELTA_UNITS.get(unit)
    if factory is None:
        _fail(f"Unsupported delta_time format in config: {spec}", logger)
        return
    parsed["delta_time"] = factory(count)


def _parse_variables(config: dict, parsed: dict, logger: Logger | None) -> None:
    spec = config["variables"]
    if spec == "all_pressure_level_vars":
        parsed["variables"] = sorted(ERA5_PRESSURE_LEVEL_VARIABLES)
        return
    if spec == "all_single_level_vars":
        _fail(
            "Error parsing variables from config: "
            "Single level variables not currently supported.",
            logger,
        )
    variables = [v.strip() for v in spec.split(",")]
    for var in variables:
        if var in ERA5_SINGLE_LEVEL_VARIABLES:
            _fail(
                f"Error parsing variables from config: "
                f"Single level variables not currently supported: {var}",
                logger,
            )
        if var not in ERA5_PRESSURE_LEVEL_VARIABLES:
            _fail(
                f"Error parsing variables from config: "
                f"Unsupported variable in config: {var}",
                logger,
            )
    parsed["variables"] = variables


def _parse_levels(config: dict, parsed: dict, logger: Logger | None) -> None:
    spec = config["levels"]
    if spec == "all":
        parsed["levels"] = sorted(ERA5_PRESSURE_LEVELS)
        return
    try:
        levels = [int(level) for level in str(spec).split(",")]
    except ValueError as err:
        _fail(f"Error parsing levels from config: {err}", logger)
        return
    for level in levels:
        if level not in ERA5_PRESSURE_LEVELS:
            _fail(
                f"Error parsing levels from config: "
                f"Unsupported level in config: {level}",
                logger,
            )
    parsed["levels"] = levels


def _derive_paths(config: dict, parsed: dict, section: str) -> None:
    """Deterministic artifact naming: ``{start}_{end}_{delta}.h5``.

    The filename is the cache key for the workdir lookup, with the
    versioned store handling everything else.
    """
    start_str = parsed["start_datetime"].strftime("%Y-%m-%dT%H")
    end_str = parsed["end_datetime"].strftime("%Y-%m-%dT%H")
    delta_str = config["delta_time"]
    root = repo_root()
    parsed["save_name"] = f"{start_str}_{end_str}_{delta_str}.h5"
    stage_dir = {
        "era5-download": "era5_download",
        "era5-svd": "era5_svd",
        "era5-dmd": "era5_dmd",
    }[section]
    parsed["save_path"] = os.path.join(root, "data", stage_dir, parsed["save_name"])
    parsed["era5_slice_path"] = os.path.join(
        root, "data", "era5_download", parsed["save_name"]
    )
    if section in ("era5-svd", "era5-dmd"):
        parsed["era5_svd_path"] = os.path.join(
            root, "data", "era5_svd", parsed["save_name"]
        )
    if section == "era5-dmd":
        parsed["era5_dmd_path"] = os.path.join(
            root, "data", "era5_dmd", parsed["save_name"]
        )


def _parse_svd_fields(config: dict, parsed: dict, logger: Logger | None) -> None:
    svd_type = config["svd_type"]
    if svd_type not in SUPPORTED_SVD_TYPES:
        _fail(
            f"Invalid SVD type in config: {svd_type}. "
            f"Supported types: {list(SUPPORTED_SVD_TYPES)}.",
            logger,
        )
    parsed["svd_type"] = svd_type

    delay = config["delay_embedding"]
    if not isinstance(delay, int) or isinstance(delay, bool) or delay < 1:
        _fail(
            f"Invalid delay embedding in config: {delay}. "
            "Delay embedding must be an integer greater than 0.",
            logger,
        )
    parsed["delay_embedding"] = delay

    for flag in ("mean_center", "scale", "save_data_matrix"):
        value = config[flag]
        if not isinstance(value, bool):
            _fail(
                f"Invalid {flag} in config: {value}. "
                f"{flag} must be a boolean value.",
                logger,
            )
        parsed[flag] = value

    n_components = config["n_components"]
    if (
        not isinstance(n_components, int)
        or isinstance(n_components, bool)
        or n_components < 1
    ):
        _fail(
            f"Invalid number of components in config: {n_components}. "
            "Number of components must be an integer greater than 0.",
            logger,
        )
    parsed["n_components"] = n_components

    # Holdout: trailing snapshots withheld from the fit so the DMD
    # stage can score its forecast against unseen truth.  Lives in the
    # SVD fields because the WITHHOLDING happens in the SVD stage: the
    # factors and the standardization statistics must come from the
    # train window only.
    holdout = config.get("forecast_holdout", 0)
    if (
        not isinstance(holdout, int)
        or isinstance(holdout, bool)
        or holdout < 0
    ):
        _fail(
            f"Invalid forecast_holdout in config: {holdout}. "
            "forecast_holdout must be a non-negative integer.",
            logger,
        )
    parsed["forecast_holdout"] = holdout

    backend = config.get("svd_backend", "auto")
    if backend not in SUPPORTED_SVD_BACKENDS:
        _fail(
            f"Invalid svd_backend in config: {backend}. "
            f"Supported backends: {list(SUPPORTED_SVD_BACKENDS)}.",
            logger,
        )
    if backend in _RANDOMIZED_ONLY_BACKENDS and svd_type != "randomized":
        _fail(
            f"Invalid svd_backend in config: {backend!r} requires "
            "svd_type = 'randomized' (the exact decomposition runs on "
            "the inmem/auto backends).",
            logger,
        )
    parsed["svd_backend"] = backend


def _parse_dmd_fields(config: dict, parsed: dict, logger: Logger | None) -> None:
    rank = config["dmd_rank"]
    if not isinstance(rank, int) or isinstance(rank, bool) or rank < 1:
        _fail(
            f"Invalid dmd_rank in config: {rank}. "
            "dmd_rank must be an integer greater than 0.",
            logger,
        )
    if rank > parsed["n_components"]:
        _fail(
            f"Invalid dmd_rank in config: {rank}. "
            f"dmd_rank must not exceed n_components ({parsed['n_components']}).",
            logger,
        )
    parsed["dmd_rank"] = rank

    optimized = config["optimized"]
    if not isinstance(optimized, bool):
        _fail(
            f"Invalid optimized in config: {optimized}. "
            "optimized must be a boolean value.",
            logger,
        )
    parsed["optimized"] = optimized

    forecast_steps = config.get("forecast_steps", 0)
    if (
        not isinstance(forecast_steps, int)
        or isinstance(forecast_steps, bool)
        or forecast_steps < 0
    ):
        _fail(
            f"Invalid forecast_steps in config: {forecast_steps}. "
            "forecast_steps must be a non-negative integer.",
            logger,
        )
    parsed["forecast_steps"] = forecast_steps

    lm_max_iter = config.get("lm_max_iter", 50)
    if (
        not isinstance(lm_max_iter, int)
        or isinstance(lm_max_iter, bool)
        or lm_max_iter < 1
    ):
        _fail(
            f"Invalid lm_max_iter in config: {lm_max_iter}. "
            "lm_max_iter must be an integer greater than 0.",
            logger,
        )
    parsed["lm_max_iter"] = lm_max_iter

    # BOP-DMD: > 0 enables bagging with that many trials (requires
    # optimized=True); 0 = a single plain fit
    bagging_trials = config.get("bagging_trials", 0)
    if (
        not isinstance(bagging_trials, int)
        or isinstance(bagging_trials, bool)
        or bagging_trials < 0
    ):
        _fail(
            f"Invalid bagging_trials in config: {bagging_trials}. "
            "bagging_trials must be a non-negative integer.",
            logger,
        )
    if bagging_trials > 0 and not parsed["optimized"]:
        _fail(
            "Invalid bagging_trials in config: bagging (BOP-DMD) "
            "requires optimized = True.",
            logger,
        )
    parsed["bagging_trials"] = bagging_trials

    bagging_fraction = config.get("bagging_fraction", 0.8)
    if (
        not isinstance(bagging_fraction, (int, float))
        or isinstance(bagging_fraction, bool)
        or not (0.0 < float(bagging_fraction) <= 1.0)
    ):
        _fail(
            f"Invalid bagging_fraction in config: {bagging_fraction}. "
            "bagging_fraction must be a number in (0, 1].",
            logger,
        )
    parsed["bagging_fraction"] = float(bagging_fraction)

    # mrDMD: > 0 enables a multiresolution hierarchy with that many
    # levels alongside the main fit; 0 = off
    mr_levels = config.get("multiresolution_levels", 0)
    if (
        not isinstance(mr_levels, int)
        or isinstance(mr_levels, bool)
        or mr_levels < 0
    ):
        _fail(
            f"Invalid multiresolution_levels in config: {mr_levels}. "
            "multiresolution_levels must be a non-negative integer.",
            logger,
        )
    parsed["multiresolution_levels"] = mr_levels

    # mrDMD escape hatch: > 0 fits the hierarchy on the RAW embedded
    # matrix at this rank (classic per-window bases) instead of inside
    # the global rank-k POD subspace — needed when transients fall
    # outside the top-k modes (see models/mrdmd.py::mrdmd_from_svd).
    mr_refit_rank = config.get("mr_refit_rank", 0)
    if (
        not isinstance(mr_refit_rank, int)
        or isinstance(mr_refit_rank, bool)
        or mr_refit_rank < 0
    ):
        _fail(
            f"Invalid mr_refit_rank in config: {mr_refit_rank}. "
            "mr_refit_rank must be a non-negative integer.",
            logger,
        )
    # No save_data_matrix requirement: with X absent from the artifact
    # the stage streams the refit out-of-core from the slice artifact
    # (era5_dmd._mr_refit_streamed — one Gram pass, no host embedding).
    parsed["mr_refit_rank"] = mr_refit_rank

    # DMDc: a control input enables the forced fit x_{k+1} ~ A x_k +
    # B u_k alongside the main decomposition.  Named synthetic
    # forcings ("diurnal", "seasonal" — harmonic pairs at the solar
    # periods, computed from the time coordinate) or a path to a saved
    # series (.npy, or .h5 with a "control" dataset) shaped (q, T-1)
    # or (q, T).  "none" = off.
    control_input = config.get("control_input", "none")
    if not isinstance(control_input, str) or (
        control_input not in ("none", "diurnal", "seasonal")
        and not control_input.endswith((".npy", ".h5", ".hdf5"))
    ):
        _fail(
            f"Invalid control_input in config: {control_input}. "
            "control_input must be 'none', 'diurnal', 'seasonal', or a "
            "path to a .npy/.h5 control series.",
            logger,
        )
    parsed["control_input"] = control_input

    rank_omega = config.get("dmdc_rank_omega", None)
    if rank_omega is not None and (
        not isinstance(rank_omega, int)
        or isinstance(rank_omega, bool)
        or rank_omega < 1
    ):
        _fail(
            f"Invalid dmdc_rank_omega in config: {rank_omega}. "
            "dmdc_rank_omega must be None or an integer greater than 0.",
            logger,
        )
    parsed["dmdc_rank_omega"] = rank_omega

    mr_max_cycles = config.get("mr_max_cycles", 1.0)
    if (
        not isinstance(mr_max_cycles, (int, float))
        or isinstance(mr_max_cycles, bool)
        or float(mr_max_cycles) <= 0.0
    ):
        _fail(
            f"Invalid mr_max_cycles in config: {mr_max_cycles}. "
            "mr_max_cycles must be a positive number.",
            logger,
        )
    parsed["mr_max_cycles"] = float(mr_max_cycles)


def _parse_tpu_fields(config: dict, parsed: dict, logger: Logger | None) -> None:
    """Optional execution fields with their defaults."""
    precision = config.get("precision", "float32")
    if precision not in SUPPORTED_PRECISIONS:
        _fail(
            f"Invalid precision in config: {precision}. "
            f"Supported precisions: {list(SUPPORTED_PRECISIONS)}.",
            logger,
        )
    parsed["precision"] = precision

    mesh_shape = config.get("mesh_shape", "auto")
    parsed["mesh_shape"] = mesh_shape

    # Multislice: DCN-axis factors, e.g. "data=2" to spread independent
    # decompositions across slices.  None/"none" = single-slice (ICI only).
    dcn = config.get("dcn_mesh_shape", None)
    parsed["dcn_mesh_shape"] = None if dcn in (None, "none", "") else dcn


def config_parser(config: dict, section: str, logger: Logger | None = None) -> dict:
    """Validate and normalize a raw config dict for one pipeline section.

    Args:
        config: Raw config dict (typically from :func:`config_reader`).
        section: ``"era5-download"`` or ``"era5-svd"``.
        logger: Optional logger for error mirroring.

    Returns:
        Parsed config dict with typed datetimes/timedeltas, expanded
        variable/level lists, derived artifact paths, and (for the SVD
        section) validated decomposition parameters.
    """
    if section not in SUPPORTED_SECTIONS:
        raise ValueError(f"Section {section} is not currently supported.")

    required = {
        "era5-download": _COMMON_REQUIRED,
        "era5-svd": _SVD_REQUIRED,
        "era5-dmd": _DMD_REQUIRED,
    }[section]
    for field in required:
        if field not in config:
            _fail(f"Missing required field in config: {field}", logger)

    parsed: dict = {"source_path": config["source_path"]}
    _parse_datetimes(config, parsed, logger)
    _parse_delta_time(config, parsed, logger)
    validate_time_parameters(parsed)
    _parse_variables(config, parsed, logger)
    _parse_levels(config, parsed, logger)
    _derive_paths(config, parsed, section)
    if section in ("era5-svd", "era5-dmd"):
        _parse_svd_fields(config, parsed, logger)
    if section == "era5-dmd":
        _parse_dmd_fields(config, parsed, logger)
    _parse_tpu_fields(config, parsed, logger)
    return parsed
