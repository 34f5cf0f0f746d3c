"""Parity of the port's spectral analysis with the JAX package's.

tests/test_24_analysis.py's three cases: ``mode_spectrum`` on the same
eigenvalues in both packages (equal arrays), and ``modes_to_grid`` on a
DMD stage result of the port's ``era5_dmd.main`` (on the CPU; test_24's
configuration, two variables at two levels, d = 2), against the JAX
package's ``modes_to_grid`` on the same FieldSet in its own containers
(equal grids) and against the flat modes at sampled sites (1e-6).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_io_h5 import to_jax
from test_torch_stage import root  # noqa: F401  (the fixture)

from dmd_era5_tpu.models import analysis as analysis_jax
from dmd_era5_tpu_torch.core import config_parser
from dmd_era5_tpu_torch.models import mode_spectrum, modes_to_grid
from dmd_era5_tpu_torch.pipeline import era5_dmd, era5_download
from dmd_era5_tpu_torch.snapmat import create_mock_era5
from dmd_era5_tpu_torch.utils.io_h5 import save_fieldset


def test_mode_spectrum_units():
    alpha = np.array([-0.1 + 2.0j, 0.0 + 0.0j, -0.5 - 0.7j], np.complex64)
    amps = np.array([1.0, 3.0, 2.0], np.float32)
    sp = mode_spectrum(alpha, amps)
    np.testing.assert_allclose(sp.growth_rate, [-0.1, 0.0, -0.5], rtol=1e-6)
    np.testing.assert_allclose(sp.e_folding[0], 10.0, rtol=1e-6)
    assert np.isinf(sp.e_folding[1]) and np.isinf(sp.period[1])
    np.testing.assert_allclose(sp.frequency[0], 2.0 / (2 * np.pi), rtol=1e-6)
    np.testing.assert_allclose(sp.period[0], 2 * np.pi / 2.0, rtol=1e-6)
    assert sp.order.tolist() == [1, 2, 0]
    for got, want in zip(sp, analysis_jax.mode_spectrum(alpha, amps)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(mode_spectrum(alpha), analysis_jax.mode_spectrum(alpha)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture()
def dmd_results(root):  # noqa: F811
    cfg = {
        "source_path": "gs://mock-bucket/era5.zarr",
        "start_datetime": "2019-06-01T00",
        "end_datetime": "2019-06-02T00",
        "delta_time": "1h",
        "variables": "temperature,u_component_of_wind",
        "levels": "1000,850",
        "svd_type": "standard",
        "delay_embedding": 2,
        "mean_center": True,
        "scale": False,
        "n_components": 8,
        "save_data_matrix": False,
        "dmd_rank": 4,
        "optimized": False,
        "forecast_steps": 0,
        "lm_max_iter": 10,
    }
    parsed = config_parser(dict(cfg), "era5-svd")
    fs = create_mock_era5(parsed["start_datetime"], parsed["end_datetime"], parsed["variables"],
                          parsed["levels"], seed=31)
    save_fieldset(era5_download.add_config_attributes(fs, parsed), parsed["era5_slice_path"])
    results, _, _ = era5_dmd.main(dict(cfg), device="cpu")
    assert isinstance(results["modes"].data, torch.Tensor)
    return results


def test_modes_to_grid_roundtrip(dmd_results):
    grids = modes_to_grid(dmd_results, delay_block=0)
    assert set(grids.variables) == {"temperature", "u_component_of_wind"}
    g = grids["temperature"]
    assert g.dims == ("level", "latitude", "longitude", "rank")
    assert g.data.shape == (2, 36, 72, 4) and isinstance(g.data, np.ndarray)
    lats = g.coords["latitude"].values
    assert lats[0] == 90.0 and lats[-1] == -85.0
    assert list(g.coords["level"].values) == [1000.0, 850.0]
    grids_j = analysis_jax.modes_to_grid(to_jax(dmd_results), delay_block=0)
    for var in grids.variables:
        np.testing.assert_array_equal(grids[var].data, grids_j[var].data)
        for c in ("level", "latitude", "longitude", "rank"):
            np.testing.assert_array_equal(grids[var].coords[c].values,
                                          grids_j[var].coords[c].values)
    modes = dmd_results["modes"]
    flat = modes.values
    variables = np.asarray(modes.coords["original_variable"].values)
    delay = np.asarray(modes.coords["delay"].values)
    lvl, lat, lon = (np.asarray(modes.coords[c].values, dtype=np.float64)
                     for c in ("level", "latitude", "longitude"))
    rows = np.random.default_rng(0).choice(flat.shape[0], size=50, replace=False)
    for row in rows[delay[rows] == 0]:
        gv = grids[str(variables[row])]
        li = list(gv.coords["level"].values).index(lvl[row])
        ai = list(gv.coords["latitude"].values).index(lat[row])
        oi = list(gv.coords["longitude"].values).index(lon[row])
        np.testing.assert_allclose(gv.data[li, ai, oi], flat[row], rtol=1e-6)


def test_modes_to_grid_delay_blocks(dmd_results):
    g0 = modes_to_grid(dmd_results, delay_block=0)
    g1 = modes_to_grid(dmd_results, delay_block=1)
    assert g0["temperature"].data.shape == g1["temperature"].data.shape
    assert not np.allclose(g0["temperature"].data, g1["temperature"].data)
    np.testing.assert_array_equal(
        g1["temperature"].data,
        analysis_jax.modes_to_grid(to_jax(dmd_results), delay_block=1)["temperature"].data)
    with pytest.raises(ValueError, match="delay block"):
        modes_to_grid(dmd_results, delay_block=5)
