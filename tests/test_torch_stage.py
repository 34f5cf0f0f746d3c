"""Parity of the port's stage mains with the JAX package's.

The download and SVD-stage cases of tests/test_06_pipeline.py (all but
the mesh case) through the port's ``era5_download.main`` /
``download_era5_data`` and ``era5_svd.main`` on the CPU
(``device="cpu"``), each against the JAX stage on the same slice: the
standard route at U up to column sign and s at rtol 1e-4, the
randomized route at s rtol 2e-3 and UᵀU to 1e-3.  Then config.ini's
mock pipeline end to end in both packages (download with the store, the
SVD stage with the store, a workdir cache hit), the standard route with
a forecast holdout and scaling, the local HDF5 ingest, and stores that
one package's stages write and the other's serve.  Each package runs
under a root of its own (``DMD_ERA5_TPU_ROOT``).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest

from dmd_era5_tpu.pipeline import era5_download as dl_jax
from dmd_era5_tpu.pipeline import era5_svd as svd_jax
from dmd_era5_tpu.snapmat import create_mock_era5 as mock_jax
from dmd_era5_tpu.utils import io_h5 as io_jax
from dmd_era5_tpu_torch.core import config_parser, config_reader
from dmd_era5_tpu_torch.pipeline import era5_download, era5_svd
from dmd_era5_tpu_torch.pipeline.artifacts import file_md5, list_versions
from dmd_era5_tpu_torch.snapmat import create_mock_era5
from dmd_era5_tpu_torch.utils.io_h5 import load_fieldset, save_fieldset

CONFIG = Path(__file__).resolve().parents[1] / "config.ini"


@pytest.fixture()
def root(tmp_path, monkeypatch):
    """use("jax" | "port" | ...) points both packages at a root of that
    name under tmp_path."""
    monkeypatch.delenv("DMD_ERA5_TPU_REMOTE", raising=False)

    def use(name: str) -> Path:
        path = tmp_path / name
        monkeypatch.setenv("DMD_ERA5_TPU_ROOT", str(path))
        return path

    use("port")
    return use


@pytest.fixture()
def dl_config():
    return {
        "source_path": "gs://mock-bucket/era5.zarr",
        "start_datetime": "2019-01-01T00",
        "end_datetime": "2019-01-02T00",
        "delta_time": "1h",
        "variables": "temperature",
        "levels": "1000",
    }


@pytest.fixture()
def svd_stage_config(dl_config):
    return {
        **dl_config,
        "svd_type": "standard",
        "delay_embedding": 2,
        "mean_center": True,
        "scale": False,
        "n_components": 5,
        "save_data_matrix": True,
    }


def stage_slice(svd_cfg, seed=5, planted=False) -> None:
    """Put a matching mock slice into the current root's workdir.

    ``planted``: a rank-10 signal added to the first variable's i.i.d.
    noise, so that the spectrum separates the leading components and
    two randomized SVDs that draw different sketches agree there."""
    parsed = config_parser(dict(svd_cfg), "era5-svd")
    fs = create_mock_era5(parsed["start_datetime"], parsed["end_datetime"],
                          parsed["variables"], parsed["levels"], seed=seed)
    if planted:
        field = fs.first()
        n_time, n_space = field.shape[0], field.data[0].size
        rng = np.random.default_rng(seed + 100)
        u0, _ = np.linalg.qr(rng.standard_normal((n_space, 10)))
        v0, _ = np.linalg.qr(rng.standard_normal((n_time, 10)))
        signal = (v0 * np.geomspace(8000.0, 3000.0, 10)) @ u0.T
        field.data = field.data + signal.reshape(field.shape)
    fs = era5_download.add_config_attributes(fs, parsed)
    save_fieldset(fs, parsed["era5_slice_path"])


def both_stages(root, cfg, seed=5, planted=False, **main_kwargs):
    """The JAX stage, then the port's (on the CPU), each under its own
    root on the same staged slice."""
    out = {}
    for name, stage in (("jax", svd_jax.main), ("port", era5_svd.main)):
        root(name)
        stage_slice(cfg, seed=seed, planted=planted)
        extra = {"device": "cpu"} if name == "port" else {}
        out[name] = stage(dict(cfg), **main_kwargs, **extra)[0]
    return out["port"], out["jax"]


def assert_u_matches_up_to_sign(u, u_j, atol):
    u_j = np.asarray(u_j, dtype=np.float64)
    signs = np.sign(np.sum(u * u_j, axis=0))
    np.testing.assert_allclose(u * signs, u_j, atol=atol)


def assert_same_layout(res, res_j):
    """Same variables, dims, coords and attrs (timing attrs aside)."""
    assert res.variables == res_j.variables
    for name in res_j.variables:
        a, b = res[name], res_j[name]
        assert a.dims == b.dims and a.shape == b.shape and a.name == b.name
        assert np.asarray(a.data).dtype == np.asarray(b.data).dtype
        assert sorted(a.coords) == sorted(b.coords)
        for cname, coord in b.coords.items():
            np.testing.assert_array_equal(a.coords[cname].values, coord.values)
    volatile = {"date_processed", "svd_seconds", "svd_gelem_per_s", "era5_slice_path"}
    assert set(res.attrs) == set(res_j.attrs)
    for key in set(res_j.attrs) - volatile:
        assert res.attrs[key] == res_j.attrs[key], key
    # the same workdir file name, under each package's own root
    assert Path(res.attrs["era5_slice_path"]).name == Path(res_j.attrs["era5_slice_path"]).name


# ------------------------------------------------------------- download


def test_download_mock_end_to_end(root, dl_config):
    np.random.seed(3)
    fs = era5_download.download_era5_data(config_parser(dict(dl_config), "era5-download"),
                                          use_mock_data=True)
    np.random.seed(3)
    fs_j = dl_jax.download_era5_data(dl_jax.config_parser(dict(dl_config), "era5-download"),
                                     use_mock_data=True)
    assert fs.attrs["source_path"] == "mock_data"
    assert fs.sizes["time"] == 25
    assert fs.attrs["hours_delta_time"] == 1.0
    np.testing.assert_array_equal(fs["temperature"].values, fs_j["temperature"].values)
    assert set(fs.attrs) == set(fs_j.attrs)


def test_download_resample(root, dl_config):
    dl_config["delta_time"] = "6h"
    np.random.seed(4)
    fs = era5_download.download_era5_data(config_parser(dict(dl_config), "era5-download"),
                                          use_mock_data=True)
    np.random.seed(4)
    fs_j = dl_jax.download_era5_data(dl_jax.config_parser(dict(dl_config), "era5-download"),
                                     use_mock_data=True)
    assert fs.sizes["time"] == 5
    np.testing.assert_array_equal(fs["temperature"].values, fs_j["temperature"].values)
    np.testing.assert_array_equal(fs.coord("time").values, fs_j.coord("time").values)


def test_download_main_with_store(root, dl_config):
    # the mock backend stamps source_path "mock_data", which the store
    # then matches on: a config that names it finds the version it added
    dl_config["source_path"] = "mock_data"
    added, retrieved = era5_download.main(dict(dl_config), use_mock_data=True, use_store=True)
    assert added and not retrieved
    added2, retrieved2 = era5_download.main(dict(dl_config), use_mock_data=True, use_store=True)
    assert retrieved2 and not added2


def test_download_from_a_local_hdf5_source(root, tmp_path, dl_config):
    """The no-network ingest path: a staged global HDF5 file is loaded,
    subset, sliced, resampled, stamped and saved, as by the JAX stage."""
    full = mock_jax("2018-12-31T18", "2019-01-02T06", ["temperature", "u_component_of_wind"],
                    [1000, 850], seed=8)
    source = tmp_path / "global.h5"
    io_jax.save_fieldset(full, source)
    cfg = dict(dl_config, source_path=str(source), delta_time="3h", levels="850")
    fs = era5_download.download_era5_data(config_parser(dict(cfg), "era5-download"))
    root("jax")
    fs_j = dl_jax.download_era5_data(dl_jax.config_parser(dict(cfg), "era5-download"))
    assert fs.variables == fs_j.variables == ["temperature"]
    assert fs.sizes == fs_j.sizes == {"time": 9, "level": 1, "latitude": 36, "longitude": 72}
    np.testing.assert_array_equal(fs["temperature"].values, fs_j["temperature"].values)
    np.testing.assert_array_equal(fs.coord("time").values, fs_j.coord("time").values)
    root("port")
    back = load_fieldset(config_parser(dict(cfg), "era5-download")["save_path"])
    np.testing.assert_array_equal(back["temperature"].values, fs_j["temperature"].values)
    assert back.attrs["source_path"] == str(source)


def test_download_from_a_zarr_store_is_not_ported(root, dl_config, monkeypatch):
    """A gs:// store is read through fsspec (snapmat/zarr_reader.py), so
    on a machine without it the stage fails with an error naming the
    package (fsspec hidden here: nothing is fetched); local stores are
    tests/test_torch_zarr.py's."""
    import sys

    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(ValueError, match="needs the fsspec package"):
        era5_download.download_era5_data(config_parser(dict(dl_config), "era5-download"))
    # main logs the failure and returns, as the JAX stage does
    assert era5_download.main(dict(dl_config)) == (False, False)


# ------------------------------------------------------------------ svd


def test_svd_stage_end_to_end(root, svd_stage_config):
    res, res_j = both_stages(root, svd_stage_config, write_artifact=True, use_store=False)
    n_space, d, k = 36 * 72, 2, 5
    assert res["U"].shape == (n_space * d, k)
    assert res["V"].shape == (k, 25 - d + 1)
    assert "X" in res and "X_mean" in res and "X_std" not in res
    assert res.attrs["svd_type"] == "standard" and res.attrs["mean_center"] == 1
    assert res.attrs["svd_backend"] == "hankel"
    np.testing.assert_array_equal(res["U"].coords["space"].values, np.arange(n_space * d))
    assert_same_layout(res, res_j)
    np.testing.assert_allclose(res["s"].values, res_j["s"].values, rtol=1e-4)
    assert_u_matches_up_to_sign(res["U"].values, res_j["U"].values, atol=1e-3)
    np.testing.assert_allclose(res["X"].values, res_j["X"].values, atol=1e-10)
    np.testing.assert_allclose(res["X_mean"].values, res_j["X_mean"].values, rtol=1e-12)
    s_host = np.linalg.svd(res["X"].values, compute_uv=False)[:k]
    np.testing.assert_allclose(res["s"].values, s_host, rtol=1e-3)
    # the artifact written loads in the JAX package as it was returned
    saved = io_jax.load_fieldset(config_parser(dict(svd_stage_config), "era5-svd")["save_path"])
    np.testing.assert_array_equal(saved["U"].values, res["U"].values)


def test_svd_stage_workdir_cache_hit(root, svd_stage_config):
    stage_slice(svd_stage_config)
    first, _, _ = era5_svd.main(dict(svd_stage_config), write_artifact=True, device="cpu")
    second, added, retrieved = era5_svd.main(dict(svd_stage_config), write_artifact=True,
                                             device="cpu")
    assert not added and not retrieved
    np.testing.assert_array_equal(second["s"].values, first["s"].values)
    np.testing.assert_array_equal(second["U"].values, first["U"].values)


def test_svd_stage_randomized(root, svd_stage_config):
    svd_stage_config.update(svd_type="randomized", save_data_matrix=False,
                            start_datetime="2019-03-01T00", end_datetime="2019-03-02T00")
    res, res_j = both_stages(root, svd_stage_config, planted=True, write_artifact=False)
    assert "X" not in res
    assert res["U"].shape[1] == svd_stage_config["n_components"]
    u = res["U"].values
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), atol=1e-3)
    np.testing.assert_allclose(res["s"].values, res_j["s"].values, rtol=2e-3)
    assert_same_layout(res, res_j)


def test_svd_stage_missing_slice_raises(root, svd_stage_config):
    svd_stage_config.update(start_datetime="2017-03-01T00", end_datetime="2017-03-02T00")
    with pytest.raises(Exception, match="Could not retrieve ERA5 slice"):
        era5_svd.main(dict(svd_stage_config), device="cpu")


def test_svd_stage_store_roundtrip(root, svd_stage_config):
    svd_stage_config.update(start_datetime="2019-02-01T00", end_datetime="2019-02-01T12")
    stage_slice(svd_stage_config)
    results, added, retrieved = era5_svd.main(dict(svd_stage_config), write_artifact=True,
                                              use_store=True, device="cpu")
    assert added and not retrieved
    os.remove(config_parser(dict(svd_stage_config), "era5-svd")["save_path"])
    results2, added2, retrieved2 = era5_svd.main(dict(svd_stage_config), write_artifact=True,
                                                 use_store=True, device="cpu")
    assert retrieved2 and not added2
    np.testing.assert_array_equal(results2["s"].values, results["s"].values)


@pytest.mark.parametrize("svd_type", ["standard", "randomized"])
def test_svd_stage_without_delay_embedding(root, svd_stage_config, svd_type):
    """d = 1 resolves to the inmem backend (truncated_svd on the device)."""
    svd_stage_config.update(delay_embedding=1, svd_type=svd_type)
    res, res_j = both_stages(root, svd_stage_config, planted=True, write_artifact=False)
    assert res.attrs["svd_backend"] == res_j.attrs["svd_backend"] == "inmem"
    assert_same_layout(res, res_j)
    exact = svd_type == "standard"
    np.testing.assert_allclose(res["s"].values, res_j["s"].values, rtol=1e-4 if exact else 2e-3)
    if exact:
        assert_u_matches_up_to_sign(res["U"].values, res_j["U"].values, atol=1e-3)


def test_svd_stage_holdout_and_scale(root, svd_stage_config):
    """The standard route with forecast_holdout > 0 and scale = True:
    statistics from the train window only, the raw holdout truth and
    the persistence baseline in the artifact."""
    svd_stage_config.update(forecast_holdout=6, scale=True, variables="temperature,u_component_of_wind",
                            levels="1000,850", start_datetime="2019-05-01T00",
                            end_datetime="2019-05-02T06")
    res, res_j = both_stages(root, svd_stage_config, write_artifact=True)
    assert_same_layout(res, res_j)
    assert res.attrs["forecast_holdout"] == 6
    assert res["V"].shape[1] == 31 - 6 - 1
    np.testing.assert_allclose(res["s"].values, res_j["s"].values, rtol=1e-4)
    assert_u_matches_up_to_sign(res["U"].values, res_j["U"].values, atol=1e-3)
    for name in ("X_mean", "X_std", "X"):
        np.testing.assert_allclose(res[name].values, res_j[name].values, rtol=1e-10, atol=1e-10)
    for name in ("holdout_truth", "holdout_persistence"):
        np.testing.assert_array_equal(res[name].values, res_j[name].values)
    with pytest.raises(Exception, match="forecast_holdout=30 leaves"):
        root("short")
        stage_slice(svd_stage_config)
        era5_svd.main(dict(svd_stage_config, forecast_holdout=30), device="cpu")


# ----------------------------------------- config.ini's mock pipeline

# the exact route, a forecast holdout and scaling on config.ini's window
STANDARD = {"svd_type": "standard", "forecast_holdout": 8, "scale": True}


def run_pipeline(download_main, svd_main, seed, overrides=None, **svd_kwargs):
    """config.ini's [era5-download] and [era5-svd] (with ``overrides``)
    on the mock backend, the global numpy state seeded: download with
    the store, the SVD stage with the store, then the stage again (a
    workdir cache hit)."""
    np.random.seed(seed)
    dl = download_main(config_reader("era5-download", CONFIG), use_mock_data=True, use_store=True)
    svd_cfg = {**config_reader("era5-svd", CONFIG), "source_path": "mock_data", **(overrides or {})}
    first = svd_main(dict(svd_cfg), write_artifact=True, use_store=True, **svd_kwargs)
    again = svd_main(dict(svd_cfg), write_artifact=True, use_store=True, **svd_kwargs)
    return dl, first, again, config_parser(svd_cfg, "era5-svd")


@pytest.mark.parametrize("overrides", [None, STANDARD], ids=["defaults", "standard_holdout_scale"])
def test_config_ini_mock_pipeline_matches_the_jax_package(root, overrides):
    """config.ini's defaults (randomized, d = 2, 10 components) and the
    exact route with a holdout and scaling.  The mock is i.i.d. noise,
    whose flat spectrum (s[9] / s[0] ~ 0.97) leaves a randomized SVD's
    Ritz values ~1% below the exact ones, entry by entry as its sketch
    falls: the two packages draw different sketches, so on the
    randomized route both are held below the exact s of the saved X and
    to each other only within 2e-2; the exact route at 1e-4."""
    root("jax")
    dl_j, (res_j, added_j, _), _, _ = run_pipeline(dl_jax.main, svd_jax.main, 21, overrides)
    root("port")
    dl, (res, added, retrieved), (again, added2, retrieved2), parsed = run_pipeline(
        era5_download.main, era5_svd.main, 21, overrides, device="cpu")
    assert dl == dl_j == (True, False)
    assert added and added_j and not retrieved
    assert not added2 and not retrieved2  # the workdir hit
    np.testing.assert_array_equal(again["U"].values, res["U"].values)
    assert res.attrs["svd_backend"] == "hankel"
    assert_same_layout(res, res_j)
    k = parsed["n_components"]
    u = res["U"].values
    np.testing.assert_allclose(res["X"].values, res_j["X"].values, rtol=1e-10, atol=1e-10)
    s_exact = np.linalg.svd(res["X"].values, compute_uv=False)[:k]
    if overrides is None:
        np.testing.assert_allclose(u.T @ u, np.eye(k), atol=1e-3)
        for s in (res["s"].values, res_j["s"].values):
            assert np.all(s <= s_exact * (1 + 1e-4))
        np.testing.assert_allclose(res["s"].values, res_j["s"].values, rtol=2e-2)
    else:
        np.testing.assert_allclose(u.T @ u, np.eye(k), atol=1e-4)
        np.testing.assert_allclose(res["s"].values, res_j["s"].values, rtol=1e-4)
        np.testing.assert_allclose(res["s"].values, s_exact, rtol=1e-4)
        assert_u_matches_up_to_sign(u, res_j["U"].values, atol=1e-3)
        for name in ("X_mean", "X_std", "holdout_truth", "holdout_persistence"):
            np.testing.assert_allclose(res[name].values, res_j[name].values, rtol=1e-10)
    logged = [m for m, _ in list_versions(parsed["save_path"], data_type="era5_svd")]
    assert logged == [file_md5(parsed["save_path"])]
    slices = list_versions(parsed["era5_slice_path"], data_type="era5_slice")
    assert len(slices) == 1 and slices[0][1]["source_path"] == "mock_data"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_the_stages_of_one_package_write_serves_the_other(root, writer):
    """One package's pipeline writes the store; with the workdir copies
    gone, the other package's stages retrieve the slice and the results
    from it (no compute) and return what was written."""
    mains = {"jax": (dl_jax.main, svd_jax.main, {}),
             "port": (era5_download.main, era5_svd.main, {"device": "cpu"})}
    reader = "port" if writer == "jax" else "jax"
    root("shared")
    dl_main, svd_main, kwargs = mains[writer]
    _, (res, added, _), _, parsed = run_pipeline(dl_main, svd_main, 22, STANDARD, **kwargs)
    assert added
    os.remove(parsed["save_path"])
    os.remove(parsed["era5_slice_path"])
    dl_main, svd_main, kwargs = mains[reader]
    dl_cfg = dict(config_reader("era5-download", CONFIG), source_path="mock_data")
    assert dl_main(dl_cfg, use_mock_data=True, use_store=True) == (False, True)
    svd_cfg = {**config_reader("era5-svd", CONFIG), "source_path": "mock_data", **STANDARD}
    back, added2, retrieved = svd_main(svd_cfg, write_artifact=True, use_store=True, **kwargs)
    assert retrieved and not added2
    np.testing.assert_array_equal(back["U"].values, res["U"].values)
    np.testing.assert_array_equal(back["s"].values, res["s"].values)
