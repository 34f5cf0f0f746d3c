"""Parity of the port's DMD stage with the JAX package's.

The cases of tests/test_11_dmd_stage.py on the optimized, exact and
bagged paths, through the port's ``era5_dmd.main`` on the CPU
(``device="cpu"``) and, where a case compares, the JAX stage's ``main``
on the same staged slice, each package under a root of its own
(``DMD_ERA5_TPU_ROOT``).

Two slices.  test_11's mock (i.i.d. noise about a mean field) is what
its structural cases use; on it the optimized fit at rank 6 chases the
noise, and two solvers stop at different points, so there the packages
are held to the same layout and attrs, and to each other only on the
exact path.  Values are compared on test_11's planted slice (two damped
travelling waves, rank 4, 1% noise) at rank 4, where every path's
eigenvalues are determined by the data: eigenvalues to 1e-5, amplitudes
and bag stds to 1e-3 relative, modes to 1e-4, the forecast to 1e-5 of
max|field|, the holdout scores to 1e-4 relative.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest
import torch
from test_11_dmd_stage import _stage_slice, _stage_slice_dynamic, _stage_slice_forced
from test_torch_io_h5 import to_jax
from test_torch_optdmd import _match
from test_torch_stage import root  # noqa: F401  (the fixture)

from dmd_era5_tpu.pipeline import era5_dmd as dmd_jax
from dmd_era5_tpu.utils import io_h5 as io_jax
from dmd_era5_tpu_torch.core import config_parser
from dmd_era5_tpu_torch.pipeline import era5_dmd, era5_svd
from dmd_era5_tpu_torch.pipeline.artifacts import file_md5, list_versions
from dmd_era5_tpu_torch.utils.io_h5 import load_fieldset, save_fieldset

N_SPACE = 36 * 72


@pytest.fixture()
def dmd_config():
    """tests/test_11_dmd_stage.py's configuration."""
    return {
        "source_path": "gs://mock-bucket/era5.zarr",
        "start_datetime": "2019-05-01T00",
        "end_datetime": "2019-05-02T00",
        "delta_time": "1h",
        "variables": "temperature",
        "levels": "1000",
        "svd_type": "standard",
        "delay_embedding": 2,
        "mean_center": True,
        "scale": False,
        "n_components": 8,
        "save_data_matrix": True,
        "dmd_rank": 6,
        "optimized": True,
        "forecast_steps": 6,
        "lm_max_iter": 30,
    }


def planted(cfg: dict, **overrides) -> dict:
    """The planted slice's window (49 hours) at rank 4."""
    return dict(cfg, start_datetime="2019-06-01T00", end_datetime="2019-06-03T00",
                dmd_rank=4, **overrides)


def both_mains(root, cfg, stage=_stage_slice, **main_kwargs):
    """The JAX stage, then the port's (on the CPU), each under its own
    root on the same staged slice."""
    out = {}
    for name, main in (("jax", dmd_jax.main), ("port", era5_dmd.main)):
        root(name)
        stage(dict(cfg))
        extra = {"device": "cpu"} if name == "port" else {}
        out[name] = main(dict(cfg), **main_kwargs, **extra)
    return out["port"], out["jax"]


# attrs that hold timings, dates or paths, or a fit's own residual
VOLATILE = {"date_processed", "svd_seconds", "svd_gelem_per_s", "era5_slice_path",
            "dmd_seconds", "lm_iterations", "dmd_residual", "multiresolution_residual",
            "dmdc_residual"}


def assert_same_layout(res, res_j):
    """Same variables, dims, dtypes, coords and attrs keys; the attrs
    that do not depend on the fit equal."""
    assert res.variables == res_j.variables
    for name in res_j.variables:
        a, b = res[name], res_j[name]
        assert a.dims == b.dims and a.shape == b.shape and a.name == b.name, name
        assert np.asarray(a.data).dtype == np.asarray(b.data).dtype, name
        assert sorted(a.coords) == sorted(b.coords), name
        for cname, coord in b.coords.items():
            assert a.coords[cname].dims == coord.dims
            np.testing.assert_array_equal(a.coords[cname].values, coord.values)
        assert a.attrs == b.attrs
    assert list(res.attrs) == list(res_j.attrs)
    for key in set(res_j.attrs) - VOLATILE:
        if not key.startswith(("forecast_", "persistence_")) or key == "forecast_holdout":
            assert res.attrs[key] == res_j.attrs[key], key
    assert Path(res.attrs["era5_slice_path"]).name == Path(res_j.attrs["era5_slice_path"]).name


def assert_values_match(res, res_j, tol=1e-5):
    """The fit's values, the eigenvalues matched nearest first: the
    eigenvalues to ``tol`` of their largest magnitude, the forecast to
    ``tol`` of max|field|, the amplitudes to 1e-3 relative and the modes
    to 1e-4."""
    eig, eig_j = res["eigenvalues"].values, res_j["eigenvalues"].values
    idx = _match(eig, eig_j)
    np.testing.assert_allclose(eig[idx], eig_j, atol=tol * np.abs(eig_j).max())
    np.testing.assert_allclose(res["amplitudes"].values[idx], res_j["amplitudes"].values,
                               rtol=1e-3)
    np.testing.assert_allclose(res["modes"].values[:, idx], res_j["modes"].values, atol=1e-4)
    if "forecast" in res_j:
        fc_j = res_j["forecast"].values
        np.testing.assert_allclose(res["forecast"].values, fc_j, rtol=0,
                                   atol=tol * np.abs(fc_j).max())
    np.testing.assert_allclose(res.attrs["dmd_residual"], res_j.attrs["dmd_residual"],
                               rtol=1e-2)
    return idx


# --------------------------------------------- tests/test_11_dmd_stage.py


def test_dmd_stage_end_to_end(root, dmd_config):
    (res, added, retrieved), (res_j, _, _) = both_mains(root, dmd_config, write_artifact=True)
    assert not added and not retrieved
    d, r = dmd_config["delay_embedding"], dmd_config["dmd_rank"]
    for out in (res, res_j):
        assert out["modes"].shape == (N_SPACE * d, r)
        assert out["eigenvalues"].shape == (r,) and np.iscomplexobj(out["eigenvalues"].values)
        assert out["amplitudes"].shape == (r,)
        assert out["forecast"].shape == (N_SPACE, 24 + 6)
        assert out.attrs["dmd_rank"] == r and out.attrs["optimized"] == 1
        assert np.isfinite(out.attrs["dmd_residual"])
        times = out["forecast"].coords["time_out"].values
        assert len(times) == 30 and times[1] - times[0] == np.timedelta64(1, "h")
    assert isinstance(res["modes"].data, torch.Tensor) and isinstance(res["forecast"].data,
                                                                       torch.Tensor)
    assert_same_layout(res, res_j)
    # the artifact written loads in the JAX package as it was returned
    saved = io_jax.load_fieldset(config_parser(dict(dmd_config), "era5-dmd")["save_path"])
    np.testing.assert_array_equal(saved["modes"].values, res["modes"].values)
    np.testing.assert_array_equal(saved["forecast"].values, res["forecast"].values)


def test_dmd_stage_workdir_cache(root, dmd_config):
    _stage_slice(dict(dmd_config))
    first, _, _ = era5_dmd.main(dict(dmd_config), write_artifact=True, device="cpu")
    second, added, retrieved = era5_dmd.main(dict(dmd_config), write_artifact=True, device="cpu")
    assert not added and not retrieved
    np.testing.assert_allclose(np.abs(second["eigenvalues"].values),
                               np.abs(first["eigenvalues"].values), rtol=1e-5)
    assert isinstance(second["modes"].data, np.ndarray)  # read back from the file


def test_dmd_artifact_roundtrip(root, dmd_config):
    dmd_config.update(start_datetime="2019-06-01T00", end_datetime="2019-06-01T18",
                      forecast_steps=0)
    _stage_slice(dict(dmd_config))
    results, added, _ = era5_dmd.main(dict(dmd_config), write_artifact=True, use_store=True,
                                      device="cpu")
    assert added
    assert "forecast" not in results
    parsed = config_parser(dict(dmd_config), "era5-dmd")
    for load in (load_fieldset, io_jax.load_fieldset):
        back = load(parsed["save_path"])
        np.testing.assert_allclose(back["modes"].values, results["modes"].values, atol=1e-6)
        assert back.attrs["optimized"] == 1
    logged = [m for m, _ in list_versions(parsed["save_path"], data_type="era5_dmd")]
    assert logged == [file_md5(parsed["save_path"])]


def test_dmd_exact_mode(root, dmd_config):
    """The exact path (no LM step) on test_11's mock: the same fit in
    both packages.  On i.i.d. noise the r x r eigenproblem is not well
    conditioned, and the JAX stage's SVD runs on the suite's 8-device
    CPU mesh: the eigenvalues agree to 1e-3 of their largest (1e-4
    read), as the port's dmd_from_svd parity holds them."""
    dmd_config.update(start_datetime="2019-07-01T00", end_datetime="2019-07-01T20",
                      optimized=False)
    (res, _, _), (res_j, _, _) = both_mains(root, dmd_config, write_artifact=False)
    assert res.attrs["optimized"] == res_j.attrs["optimized"] == 0
    assert res.attrs["lm_iterations"] == res_j.attrs["lm_iterations"] == 0
    assert_same_layout(res, res_j)
    assert_values_match(res, res_j, tol=1e-3)


@pytest.mark.parametrize("path", ["optimized", "exact", "bagged"])
def test_dmd_paths_match_the_jax_stage(root, dmd_config, path):
    """Each path on the planted slice at rank 4, against the JAX stage."""
    overrides = {"optimized": {}, "exact": {"optimized": False},
                 "bagged": {"bagging_trials": 6, "bagging_fraction": 0.75}}[path]
    cfg = planted(dmd_config, **overrides)
    (res, _, _), (res_j, _, _) = both_mains(root, cfg, stage=_stage_slice_dynamic,
                                            write_artifact=True)
    assert_same_layout(res, res_j)
    idx = assert_values_match(res, res_j)
    truth = np.array([-0.005 + 0.35j, -0.005 - 0.35j, -0.02 + 0.8j, -0.02 - 0.8j])
    got = res["eigenvalues"].values
    assert max(min(abs(got - a)) for a in truth) < 2e-3
    if path == "bagged":
        assert res.attrs["bagging_trials_used"] == res_j.attrs["bagging_trials_used"] == 6
        for name in ("eigenvalues_std", "amplitudes_std"):
            a, b = res[name].values[idx], res_j[name].values
            assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), name
        a, b = res["modes_std"].values[:, idx], res_j["modes_std"].values
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()


def test_dmd_forecast_reconstructs_training_window(root, dmd_config):
    """The rollout over the training window approximates the raw
    (unstandardized) mock data: the full inverse-transform chain."""
    dmd_config.update(start_datetime="2019-08-01T00", end_datetime="2019-08-02T00",
                      n_components=8, dmd_rank=8)
    _stage_slice(dict(dmd_config))
    results, _, _ = era5_dmd.main(dict(dmd_config), write_artifact=False, device="cpu")
    raw = load_fieldset(config_parser(dict(dmd_config), "era5-svd")["era5_slice_path"])
    t_raw = raw["temperature"].transpose("level", "latitude", "longitude", "time").values
    t_raw = t_raw.reshape(-1, 25)
    d = dmd_config["delay_embedding"]
    window = t_raw[:, d - 1 :]  # forecast rows align with times[d-1:]
    fc = results["forecast"].values[:, : 25 - d + 1]
    rel = np.linalg.norm(fc - window) / np.linalg.norm(window)
    assert np.isfinite(rel) and rel < 0.2


def test_dmd_stage_bagged(root, dmd_config):
    """BOP-DMD through the stage: uncertainty fields and cache keying."""
    dmd_config.update(bagging_trials=6, bagging_fraction=0.75)
    _stage_slice(dict(dmd_config))
    results, _, _ = era5_dmd.main(dict(dmd_config), write_artifact=True, device="cpu")
    r = dmd_config["dmd_rank"]
    assert results.attrs["bagging_trials"] == 6
    assert 1 <= results.attrs["bagging_trials_used"] <= 6
    assert results["eigenvalues_std"].shape == results["amplitudes_std"].shape == (r,)
    assert results["modes_std"].shape == (N_SPACE * 2, r)
    assert np.all(results["eigenvalues_std"].values >= 0)
    assert np.all(np.isfinite(results["modes_std"].values))
    assert "forecast" in results
    # a plain-optDMD config must NOT hit the bagged artifact's cache
    plain, _, retrieved = era5_dmd.main(dict(dmd_config, bagging_trials=0), device="cpu")
    assert not retrieved and "eigenvalues_std" not in plain


def test_dmd_corrupt_cached_artifact_is_recomputed(root, dmd_config):
    """A cached fit with non-finite amplitudes is not served."""
    _stage_slice(dict(dmd_config))
    first, _, _ = era5_dmd.main(dict(dmd_config), write_artifact=True, device="cpu")
    parsed = config_parser(dict(dmd_config), "era5-dmd")
    corrupt = load_fieldset(parsed["save_path"])
    corrupt["amplitudes"].data = np.full_like(np.asarray(corrupt["amplitudes"].data), np.nan)
    save_fieldset(corrupt, parsed["save_path"])
    assert not era5_dmd.check_dmd_results(corrupt, parsed)
    results, _, retrieved = era5_dmd.main(dict(dmd_config), write_artifact=True, device="cpu")
    assert not retrieved
    assert np.isfinite(results["amplitudes"].values).all()
    np.testing.assert_allclose(np.abs(results["eigenvalues"].values),
                               np.abs(first["eigenvalues"].values), atol=1e-5)


@pytest.mark.parametrize("rank", [8, 4])
def test_dmd_forecast_holdout_scores_beat_persistence(root, dmd_config, rank):
    """Fit on train, score on the withheld truth (test_11's case at its
    rank 8, and at the planted rank 4).  At rank 8 four eigenvalues fit
    the noise, where the two solvers stop at different points: the
    packages' DMD scores agree to 2e-2 there, to 1e-4 at rank 4; the
    persistence scores do not depend on the fit and agree to 1e-6."""
    holdout = 8
    cfg = dict(dmd_config, start_datetime="2019-06-01T00", end_datetime="2019-06-03T00",
               forecast_holdout=holdout, forecast_steps=0, n_components=8, dmd_rank=rank)
    (res, _, _), (res_j, _, _) = both_mains(root, cfg, stage=_stage_slice_dynamic,
                                            write_artifact=True)
    assert_same_layout(res, res_j)
    for out in (res, res_j):
        assert out.attrs["forecast_holdout"] == holdout
        rmse, acc, p_rmse = (out.attrs[k] for k in ("forecast_rmse", "forecast_acc",
                                                     "persistence_rmse"))
        assert len(rmse) == len(acc) == len(out.attrs["forecast_bias"]) == holdout
        assert all(np.isfinite(rmse)) and all(np.isfinite(acc))
        assert rmse[-1] < 0.5 * p_rmse[-1], (rmse, p_rmse)
        assert acc[-1] > 0.9, acc
    rtol = 2e-2 if rank == 8 else 1e-4
    for key in ("rmse", "acc"):
        np.testing.assert_allclose(res.attrs[f"forecast_{key}"], res_j.attrs[f"forecast_{key}"],
                                   rtol=rtol)
    np.testing.assert_allclose(res.attrs["forecast_bias"], res_j.attrs["forecast_bias"], rtol=0,
                               atol=rtol * max(res_j.attrs["forecast_rmse"]))
    for key in ("rmse", "acc", "bias"):
        np.testing.assert_allclose(res.attrs[f"persistence_{key}"],
                                   res_j.attrs[f"persistence_{key}"], rtol=1e-6, atol=1e-6)
    # the SVD artifact carried the raw truth and was fit on train only
    svd_fs = load_fieldset(config_parser(dict(cfg), "era5-svd")["era5_svd_path"])
    assert svd_fs["holdout_truth"].shape[1] == holdout
    assert svd_fs["V"].shape[1] == 49 - holdout - (cfg["delay_embedding"] - 1)
    # cache key: a different holdout must not reuse this artifact
    other = config_parser(dict(cfg, forecast_holdout=4), "era5-dmd")
    assert not era5_dmd.check_dmd_results(res, other)


# ------------------------------------------------- mrDMD and DMDc


def discrete(omega, dt=1.0):
    """The discrete eigenvalues exp(omega dt) of continuous ones: a
    negative real eigenvalue's log lies on the branch cut, at +i pi or
    -i pi by the sign of a roundoff imaginary part, and a mode damped
    within a step has an omega that noise sets; both are one point here."""
    return np.exp(np.asarray(omega, np.complex128) * dt)


def assert_mr_levels_match(res, res_j, levels, atol):
    """Each level's eigenvalues, as discrete ones (hourly steps), matched
    per window within ``atol`` (never by ``np.sort_complex`` order: it
    sorts by the real part first), and equal slow and kept counts."""
    for lvl in range(levels):
        om, om_j = (discrete(r[f"mr_eigenvalues_L{lvl}"].values) for r in (res, res_j))
        assert om.shape == om_j.shape
        for w in range(om_j.shape[0]):
            idx = _match(om[w], om_j[w])
            np.testing.assert_allclose(om[w][idx], om_j[w], rtol=0, atol=atol)
        for mask in ("mr_slow_mask", "mr_kept_mask"):
            assert res[f"{mask}_L{lvl}"].values.sum() == res_j[f"{mask}_L{lvl}"].values.sum()


def test_dmd_stage_multiresolution(root, dmd_config):
    """multiresolution_levels > 0 adds the per-level mrDMD fields, fit in
    the POD subspace (test_11's case), in both packages alike."""
    dmd_config.update(multiresolution_levels=2, mr_max_cycles=1.5)
    (res, _, _), (res_j, _, _) = both_mains(root, dmd_config, write_artifact=True)
    assert_same_layout(res, res_j)
    n_space = N_SPACE * dmd_config["delay_embedding"]
    r = dmd_config["dmd_rank"]
    assert res["mr_eigenvalues_L0"].shape == (1, r) and res["mr_eigenvalues_L1"].shape == (2, r)
    assert res["mr_modes_L0"].shape == (1, n_space, r) and res["mr_modes_L1"].shape == (2, n_space, r)
    assert isinstance(res["mr_modes_L1"].data, torch.Tensor)
    assert res["mr_slow_mask_L0"].values.dtype == np.int8
    norms = np.linalg.norm(res["mr_modes_L0"].values[0], axis=0)
    live = norms > 1e-6
    np.testing.assert_allclose(norms[live], 1.0, rtol=1e-4)
    assert res.attrs["multiresolution_levels"] == 2 and res.attrs["mr_t_used"] == 24
    res_rel = res.attrs["multiresolution_residual"]
    assert np.isfinite(res_rel) and 0.0 <= res_rel < 1.0
    np.testing.assert_allclose(res_rel, res_j.attrs["multiresolution_residual"], atol=2e-2)
    assert_mr_levels_match(res, res_j, 2, atol=5e-3)
    # the artifact round-trips and the cache check keys on the levels
    parsed = config_parser(dict(dmd_config), "era5-dmd")
    reloaded = load_fieldset(parsed["save_path"])
    np.testing.assert_array_equal(reloaded["mr_eigenvalues_L1"].values,
                                  res["mr_eigenvalues_L1"].values)
    np.testing.assert_array_equal(reloaded["mr_modes_L1"].values, res["mr_modes_L1"].values)
    assert era5_dmd.check_dmd_results(reloaded, parsed)
    plain = config_parser(dict(dmd_config, multiresolution_levels=0), "era5-dmd")
    assert not era5_dmd.check_dmd_results(reloaded, plain)


@pytest.mark.parametrize("route", ["in_memory", "streamed"])
def test_dmd_stage_multiresolution_refit(root, dmd_config, route):
    """mr_refit_rank: the hierarchy refit on the raw embedded matrix, from
    the artifact's X (save_data_matrix) or, without X, streamed from the
    slice artifact through a packed file; each against the JAX stage's
    same route on the planted slice."""
    cfg = planted(dmd_config, multiresolution_levels=2, mr_refit_rank=4,
                  save_data_matrix=route == "in_memory", forecast_steps=0)
    (res, _, _), (res_j, _, _) = both_mains(root, cfg, stage=_stage_slice_dynamic,
                                            write_artifact=False)
    assert_same_layout(res, res_j)
    assert res.attrs["mr_refit_rank"] == 4 and res["mr_eigenvalues_L1"].shape == (2, 4)
    t_used = res.attrs["mr_t_used"]
    n_space = N_SPACE * cfg["delay_embedding"]
    if route == "in_memory":
        assert res["mr_modes_L0"].shape == (1, n_space, 4)
        assert "mr_mode_map_L0" not in res
    else:
        assert res["mr_mode_map_L0"].shape == (1, t_used, 4)
        assert res["mr_modes_L1"].shape == (2, n_space, 4)  # under the 2 GB budget
    res_rel = res.attrs["multiresolution_residual"]
    assert np.isfinite(res_rel) and 0.0 <= res_rel < 1.0
    np.testing.assert_allclose(res_rel, res_j.attrs["multiresolution_residual"], atol=2e-3)
    assert_mr_levels_match(res, res_j, 2, atol=5e-3)
    # subspace and refit hierarchies are different artifacts
    assert not era5_dmd.check_dmd_results(res, config_parser(dict(cfg, mr_refit_rank=0),
                                                             "era5-dmd"))


def test_mr_refit_streams_without_data_matrix(root, dmd_config):
    """test_11's case: the streamed refit (no X in the SVD artifact)
    against the in-memory refit, both the port's, on test_11's mock:
    eigenvalues matched within 2e-2, the residual share within 2e-2."""
    cfg = dict(dmd_config, start_datetime="2019-09-03T00", end_datetime="2019-09-04T00",
               multiresolution_levels=2, mr_refit_rank=4, save_data_matrix=False,
               forecast_steps=0)
    _stage_slice(dict(cfg))
    res, _, _ = era5_dmd.main(dict(cfg), device="cpu")
    t_used = res.attrs["mr_t_used"]
    assert res["mr_mode_map_L0"].shape == (1, t_used, 4)
    assert not os.path.exists(str(config_parser(dict(cfg), "era5-dmd")["save_path"])
                              + ".mr.packed.npy")
    ref, _, _ = era5_dmd.main(dict(cfg, save_data_matrix=True), device="cpu")
    assert_mr_levels_match(res, ref, 2, atol=2e-2)
    np.testing.assert_allclose(res.attrs["multiresolution_residual"],
                               ref.attrs["multiresolution_residual"], atol=2e-2)


def test_dmd_stage_dmdc(root, dmd_config):
    """control_input = diurnal on a slice with a known diurnal forcing
    (test_11's case): the series equals the generator's (absolute phase,
    transition-aligned), the forced model explains the transitions, the
    control input keys the cache; the fit against the JAX stage's."""
    cfg = dict(dmd_config, start_datetime="2019-07-01T00", end_datetime="2019-07-03T00",
               control_input="diurnal", forecast_steps=0, n_components=8, dmd_rank=6)
    out = {}
    for name, main in (("jax", dmd_jax.main), ("port", era5_dmd.main)):
        root(name)
        u_gen = _stage_slice_forced(dict(cfg))
        out[name] = main(dict(cfg), write_artifact=True,
                         **({"device": "cpu"} if name == "port" else {}))[0]
    res, res_j = out["port"], out["jax"]
    assert_same_layout(res, res_j)
    r, d = cfg["dmd_rank"], cfg["delay_embedding"]
    assert res["dmdc_eigenvalues"].shape == (r,) and res["dmdc_a_red"].shape == (r, r)
    assert res["dmdc_modes"].shape == (N_SPACE * d, r) and res["dmdc_b_red"].shape == (r, 2)
    assert isinstance(res["dmdc_modes"].data, torch.Tensor)
    assert res.attrs["control_input"] == "diurnal"
    np.testing.assert_allclose(res["dmdc_control"].values, u_gen[:, d - 1 : -1], atol=1e-5)
    np.testing.assert_array_equal(res["dmdc_control"].values, res_j["dmdc_control"].values)
    assert res.attrs["dmdc_residual"] < 0.2
    np.testing.assert_allclose(res.attrs["dmdc_residual"], res_j.attrs["dmdc_residual"],
                               rtol=1e-2)
    eig, eig_j = (discrete(r["dmdc_eigenvalues"].values) for r in (res, res_j))
    idx = _match(eig, eig_j)
    np.testing.assert_allclose(eig[idx], eig_j, rtol=0, atol=2e-3)
    other = config_parser(dict(cfg, control_input="none"), "era5-dmd")
    assert not era5_dmd.check_dmd_results(res, other)
    parsed = config_parser(dict(cfg), "era5-dmd")
    assert era5_dmd.check_dmd_results(load_fieldset(parsed["save_path"]), parsed)


@pytest.mark.parametrize("kind", ["npy", "h5"])
def test_dmd_stage_dmdc_from_file(root, dmd_config, tmp_path, kind):
    """A control series from a .npy file, or an .h5 file's ``control``
    dataset, aligned with the artifact's time axis (T = 24 at d = 2),
    its last column dropped; the same fit as the JAX stage's."""
    import h5py

    cfg = dict(dmd_config, start_datetime="2019-08-01T00", end_datetime="2019-08-02T00",
               forecast_steps=0, n_components=8, dmd_rank=6)
    t_emb = 25 - (cfg["delay_embedding"] - 1)
    series = np.random.default_rng(0).standard_normal((3, t_emb)).astype(np.float32)
    path = tmp_path / f"ctrl.{kind}"
    if kind == "npy":
        np.save(path, series)
    else:
        with h5py.File(path, "w") as f:
            f["control"] = series
    cfg["control_input"] = str(path)
    (res, _, _), (res_j, _, _) = both_mains(root, cfg, write_artifact=False)
    assert res["dmdc_b_red"].shape == (6, 3) and res["dmdc_control"].shape == (3, t_emb - 1)
    np.testing.assert_array_equal(res["dmdc_control"].values, series[:, :-1])
    assert_same_layout(res, res_j)
    bad = tmp_path / "bad.h5"
    with h5py.File(bad, "w") as f:
        f["other"] = series
    with pytest.raises(ValueError, match="no 'control' dataset"):
        era5_dmd._control_series(str(bad), np.arange(t_emb).astype("datetime64[h]"))


def test_main_needs_a_card_unless_told_otherwise(root, dmd_config, monkeypatch):
    """``era5_dmd.main`` without ``device`` computes on the card: without
    CUDA it raises instead of running on the host, also when the SVD
    results come from the cache."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _stage_slice(dict(dmd_config))
    with pytest.raises(Exception, match="CUDA card"):
        era5_dmd.main(dict(dmd_config))
    era5_svd.main(dict(dmd_config), write_artifact=True, device="cpu")
    with pytest.raises(Exception, match="CUDA card"):
        era5_dmd.main(dict(dmd_config))
    assert era5_dmd.main(dict(dmd_config), device="cpu")[0]["modes"].shape == (N_SPACE * 2, 6)


# ----------------------------------------------------- across packages


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dmd_artifacts_cross_between_packages(root, dmd_config, writer):
    """A DMD artifact (complex modes) that one package's stage writes and
    versions serves the other's cache ladder from the store, with the
    workdir copy gone; and one FieldSet gives both writers one md5."""
    mains = {"jax": (dmd_jax.main, {}), "port": (era5_dmd.main, {"device": "cpu"})}
    reader = "port" if writer == "jax" else "jax"
    cfg = planted(dmd_config, forecast_steps=3)
    root("shared")
    _stage_slice_dynamic(dict(cfg))
    main, kwargs = mains[writer]
    res, added, _ = main(dict(cfg), write_artifact=True, use_store=True, **kwargs)
    assert added
    parsed = config_parser(dict(cfg), "era5-dmd")
    os.remove(parsed["save_path"])
    main, kwargs = mains[reader]
    back, added2, retrieved = main(dict(cfg), write_artifact=True, use_store=True, **kwargs)
    assert retrieved and not added2
    for name in ("modes", "eigenvalues", "amplitudes", "forecast"):
        np.testing.assert_array_equal(back[name].values, res[name].values)
    assert back.attrs["dmd_rank"] == 4
    # one FieldSet, both writers: the same bytes
    fs = back if reader == "port" else load_fieldset(parsed["save_path"])
    save_fieldset(fs, parsed["save_path"] + ".port.h5")
    io_jax.save_fieldset(to_jax(fs), parsed["save_path"] + ".jax.h5")
    assert file_md5(parsed["save_path"] + ".port.h5") == file_md5(parsed["save_path"] + ".jax.h5")
