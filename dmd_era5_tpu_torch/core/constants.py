"""Whitelists of supported ERA5 variables and pressure levels.

The port's copy of ``dmd_era5_tpu/core/constants.py``: three
pressure-level variables, three single-level variables (recognized but rejected by the
config parser), and the thirteen standard pressure levels 50-1000 hPa.
"""

from __future__ import annotations

ERA5_PRESSURE_LEVEL_VARIABLES: set[str] = {
    "temperature",
    "u_component_of_wind",
    "v_component_of_wind",
}

ERA5_SINGLE_LEVEL_VARIABLES: set[str] = {
    "2m_temperature",
    "10m_u_component_of_wind",
    "10m_v_component_of_wind",
}

ERA5_VARIABLES: set[str] = ERA5_PRESSURE_LEVEL_VARIABLES | ERA5_SINGLE_LEVEL_VARIABLES

ERA5_PRESSURE_LEVELS: set[int] = {
    50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000,
}
