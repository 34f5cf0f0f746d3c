"""Parity of the port's streaming sketch, rank update and incremental
SVD stage with the JAX package's.

The cases of ``tests/test_10_streaming.py:13-97`` (``StreamingSketch``,
``svd_rank_update``) and ``tests/test_15_incremental.py:34-165``
(``update_svd_results``, ``era5_svd_update.main`` through the files and
the store), and the ``onepass`` backend through ``era5_svd.main``
(``tests/test_20_svd_backends.py:208``), on the CPU (``device="cpu"``;
the kernels take their plain PyTorch versions and count no launch).
Each package's stages run under a root of their own
(``DMD_ERA5_TPU_ROOT``).  Tolerances are those files' unless a test
states a tighter one; the port's U^T C sums in f32 chunks on the CPU
(in f64 on the card), the JAX package's in f32.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.ops import exact_truncated_svd as exact_jax
from dmd_era5_tpu.ops.streaming import StreamingSketch as SketchJax
from dmd_era5_tpu.ops.streaming import svd_rank_update as update_jax
from dmd_era5_tpu.pipeline import era5_download as dl_jax
from dmd_era5_tpu.pipeline import era5_svd as svd_jax
from dmd_era5_tpu.pipeline import era5_svd_update as stage_update_jax
from dmd_era5_tpu.pipeline.incremental import update_svd_results as update_results_jax
from dmd_era5_tpu.snapmat import create_mock_era5 as mock_jax
from dmd_era5_tpu.utils import io_h5 as io_jax
from dmd_era5_tpu_torch.core import config_parser
from dmd_era5_tpu_torch.ops import matmul as tmatmul
from dmd_era5_tpu_torch.ops import streaming
from dmd_era5_tpu_torch.ops.streaming import StreamingSketch, svd_rank_update
from dmd_era5_tpu_torch.ops.svd import SVDResult
from dmd_era5_tpu_torch.pipeline import era5_download, era5_svd, era5_svd_update
from dmd_era5_tpu_torch.pipeline.incremental import update_svd_results
from dmd_era5_tpu_torch.snapmat import (
    apply_delay_embedding,
    create_mock_era5,
    delay_embed_np,
    flatten_era5_variables,
    standardize_data,
)
from dmd_era5_tpu_torch.utils.io_h5 import save_fieldset


# ------------------------------------------------------- streaming sketch

@pytest.mark.parametrize("bounds", [list(range(0, 97, 16)), [0, 7, 19, 33, 50]])
def test_streaming_sketch_matches_one_shot(rng, bounds):
    """test_10:13-40: even and uneven column blocks, Y = X Omega (rtol
    1e-4, atol 1e-3), the same Y as the JAX sketch's."""
    s, t, r = 256, bounds[-1], 16
    x = rng.standard_normal((s, t)).astype(np.float32)
    omega = rng.standard_normal((t, r)).astype(np.float32)
    sketch = StreamingSketch(s, torch.from_numpy(omega))
    ref = SketchJax(s, jnp.asarray(omega))
    for a, b in zip(bounds, bounds[1:]):
        sketch.update(x[:, a:b])
        ref.update(x[:, a:b])
    assert sketch.columns_seen == t
    y = sketch.result().numpy()
    np.testing.assert_allclose(y, x @ omega, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(y, np.asarray(ref.result()), rtol=1e-4, atol=1e-3)
    again = StreamingSketch(s, omega).run(x[:, a:b] for a, b in zip(bounds, bounds[1:]))
    assert torch.equal(again, sketch.result())


def test_streaming_sketch_empty_raises():
    with pytest.raises(ValueError, match="No blocks"):
        StreamingSketch(8, torch.zeros((4, 2))).result()


# ------------------------------------------------------------- rank update

def _base(x0: np.ndarray, k: int):
    """One base SVD (the JAX package's exact one) for both packages."""
    svd0 = exact_jax(jnp.asarray(x0), k)
    return svd0, SVDResult(*(torch.from_numpy(np.array(a)) for a in svd0))


def _recon(res) -> np.ndarray:
    u, s, v = (np.asarray(a, dtype=np.float64) for a in res)
    return (u * s[None, :]) @ v


@pytest.mark.parametrize("case", ["appends", "truncates_noise", "pipeline"])
def test_svd_rank_update_matches_jax(rng, monkeypatch, case):
    """test_10:46-97: s against the host SVD of [X0, C] (rtol 1e-3 /
    2e-3), V's width, the reconstruction (atol 2e-2), U^T U (atol 1e-3),
    and against the JAX update from the same base: s within 1e-5
    relative, the rank-k reconstruction within 1e-4 of max.  The lift
    runs in row chunks (LIFT_ROWS made small), on the plain versions."""
    monkeypatch.setattr(streaming, "LIFT_ROWS", 100)
    if case == "appends":
        s, t0, c, k = 384, 48, 16, 12
        basis = rng.standard_normal((s, k))
        x0 = (basis @ rng.standard_normal((k, t0))).astype(np.float32)
        xc = (basis @ rng.standard_normal((k, c))).astype(np.float32)
    elif case == "truncates_noise":
        s, t0, c, k = 256, 40, 8, 6
        basis = rng.standard_normal((s, k))
        x0 = (basis @ rng.standard_normal((k, t0))).astype(np.float32)
        xc = (basis @ rng.standard_normal((k, c))
              + 1e-3 * rng.standard_normal((s, c))).astype(np.float32)
    else:  # test_10:82: stream a day, factor, append a day
        s, t0, k = 512, 24, 8
        x0 = (rng.standard_normal((s, k)) @ rng.standard_normal((k, t0))).astype(np.float32)
        xc = (x0[:, :k] @ rng.standard_normal((k, t0))).astype(np.float32)
        c = t0
    svd0_j, svd0 = _base(x0, k)
    before = (tmatmul.matmul.launches, tmatmul.project.launches)
    updated = svd_rank_update(svd0, torch.from_numpy(xc), n_components=k)
    assert (tmatmul.matmul.launches, tmatmul.project.launches) == before
    ref = update_jax(svd0_j, jnp.asarray(xc), n_components=k)
    full = np.concatenate([x0, xc], axis=1)
    s_host = np.linalg.svd(full, compute_uv=False)[:k]
    assert tuple(updated.s.shape) == (k,) and tuple(updated.V.shape) == (k, t0 + c)
    u = updated.U.numpy()
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=1e-3)
    np.testing.assert_allclose(updated.s.numpy(), s_host, rtol=1e-3 if case != "pipeline" else 2e-3)
    if case == "appends":
        np.testing.assert_allclose(_recon(updated), full, atol=2e-2)
    np.testing.assert_allclose(updated.s.numpy(), np.asarray(ref.s), rtol=1e-5)
    rec_j = _recon(ref)
    np.testing.assert_allclose(_recon(updated), rec_j, atol=1e-4 * np.abs(rec_j).max())


# ---------------------------------------------------- the incremental stage

@pytest.fixture()
def root(tmp_path, monkeypatch):
    """use("jax" | "port") points both packages at a root of that name."""
    monkeypatch.delenv("DMD_ERA5_TPU_REMOTE", raising=False)

    def use(name: str):
        monkeypatch.setenv("DMD_ERA5_TPU_ROOT", str(tmp_path / name))

    return use


@pytest.fixture()
def base_config():
    return {
        "source_path": "gs://mock-bucket/era5.zarr",
        "start_datetime": "2019-09-01T00",
        "end_datetime": "2019-09-02T00",
        "delta_time": "1h",
        "variables": "temperature",
        "levels": "1000",
        "svd_type": "standard",
        "delay_embedding": 2,
        "mean_center": True,
        "scale": False,
        "n_components": 8,
        "save_data_matrix": False,
        "precision": "float32",
    }


# each package's (config parser, mock, download stamp, HDF5 writer, SVD stage)
def _port_stage():
    return config_parser, create_mock_era5, era5_download, save_fieldset, era5_svd


def _jax_stage():
    from dmd_era5_tpu.core.config_parser import config_parser as parse_jax

    return parse_jax, mock_jax, dl_jax, io_jax.save_fieldset, svd_jax


def _stage_slice(pkg, cfg: dict, seed: int, end: str | None = None):
    parse, mock, dl, save, _ = pkg
    cfg = {**cfg, "end_datetime": end or cfg["end_datetime"]}
    parsed = parse(dict(cfg), "era5-svd")
    fs = mock(parsed["start_datetime"], parsed["end_datetime"], parsed["variables"],
              parsed["levels"], seed=seed)
    fs = dl.add_config_attributes(fs, parsed)
    save(fs, parsed["era5_slice_path"])
    return fs


def test_update_svd_results_extends_time(root, base_config):
    """test_15:34: V's time grows by the new embedded columns, U stays
    orthonormal (atol 2e-3), the seam is strictly increasing, s against
    the SVD of [U s V, new columns] (rtol 2e-3); against the JAX update
    of the JAX stage's artifact: s within 1e-4, the same time coord, the
    attrs."""
    out = {}
    for name, pkg, update in (("jax", _jax_stage(), update_results_jax),
                              ("port", _port_stage(), update_svd_results)):
        root(name)
        _stage_slice(pkg, base_config, seed=31)
        extra = {"device": "cpu"} if name == "port" else {}
        results = pkg[4].main(dict(base_config), write_artifact=False, **extra)[0]
        new_slice = pkg[1]("2019-09-02T01", "2019-09-02T12", ["temperature"], [1000], seed=32)
        out[name] = results, new_slice, update(results, new_slice, **extra)
    results, new_slice, updated = out["port"]
    _, _, updated_j = out["jax"]
    d = base_config["delay_embedding"]
    t_old = results["V"].sizes["time"]
    assert updated["V"].sizes["time"] == t_old + 12 - d + 1
    assert updated["s"].shape == (8,) and updated["U"].shape == results["U"].shape
    assert all(isinstance(updated[n].data, np.ndarray) for n in ("U", "s", "V"))
    u = updated["U"].values
    np.testing.assert_allclose(u.T @ u, np.eye(8), atol=2e-3)
    times = updated["V"].coords["time"].values
    assert np.all(np.diff(times).astype(np.int64) > 0)
    x_new = np.asarray(flatten_era5_variables(new_slice).data, np.float32)
    x_new = x_new - results["X_mean"].values[: x_new.shape[0], None]
    history = results["U"].values @ np.diag(results["s"].values) @ results["V"].values
    full = np.concatenate([history, delay_embed_np(x_new, d)], axis=1)
    s_host = np.linalg.svd(full, compute_uv=False)[:8]
    np.testing.assert_allclose(updated["s"].values, s_host, rtol=2e-3)
    np.testing.assert_allclose(updated["s"].values, updated_j["s"].values, rtol=1e-4)
    np.testing.assert_array_equal(times, updated_j["V"].coords["time"].values)
    for key in ("n_components", "delay_embedding", "variables"):
        assert updated.attrs[key] == updated_j.attrs[key], key
    # the same instant (the packages' mocks keep time in ns and in us)
    assert (np.datetime64(updated.attrs["updated_through"])
            == np.datetime64(updated_j.attrs["updated_through"]))


def test_update_needs_a_card_unless_told_otherwise(root, base_config, monkeypatch):
    root("port")
    _stage_slice(_port_stage(), base_config, seed=31)
    results = era5_svd.main(dict(base_config), device="cpu")[0]
    new_slice = create_mock_era5("2019-09-02T01", "2019-09-02T03", ["temperature"], [1000],
                                 seed=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        update_svd_results(results, new_slice)


def test_incremental_stage_extends_artifact(root, base_config):
    """test_15:83: fit day 1 with the store, extend with day 2 through
    ``era5_svd_update.main`` (the base found by the store scan), written
    and versioned; a second run does nothing; against the from-scratch
    fit: s[:4] rtol 2e-2, the leading mode's cos > 0.999, the rank-8
    reconstruction within 0.02 of optimal, V over the full window; and
    the same stage in the JAX package: s within 1e-4."""
    cfg = {**base_config, "mean_center": False}
    full_cfg = {**cfg, "end_datetime": "2019-09-03T00"}
    out = {}
    for name, pkg, stage in (("jax", _jax_stage(), stage_update_jax),
                             ("port", _port_stage(), era5_svd_update)):
        root(name)
        extra = {"device": "cpu"} if name == "port" else {}
        _stage_slice(pkg, cfg, seed=77)
        pkg[4].main(dict(cfg), write_artifact=True, use_store=True, **extra)
        fs_full = _stage_slice(pkg, cfg, seed=77, end=full_cfg["end_datetime"])
        updated, added, did = stage.main(dict(full_cfg), write_artifact=True, use_store=True,
                                         **extra)
        assert did and added
        again, added2, did2 = stage.main(dict(full_cfg), write_artifact=False, use_store=True,
                                         **extra)
        assert not did2 and not added2
        out[name] = updated, fs_full
    updated, fs_full = out["port"]
    x_full = np.asarray(apply_delay_embedding(
        flatten_era5_variables(fs_full[["temperature"]]), 2).data, np.float32)
    u_host, s_host, _ = np.linalg.svd(x_full, full_matrices=False)
    s_inc = updated["s"].values
    np.testing.assert_allclose(s_inc[:4], s_host[:4], rtol=2e-2)
    u0 = updated["U"].values[:, 0]
    assert abs(float(u0 @ u_host[:, 0]) / np.linalg.norm(u0)) > 0.999
    recon = updated["U"].values @ np.diag(s_inc) @ updated["V"].values
    rel_inc = np.linalg.norm(x_full - recon) / np.linalg.norm(x_full)
    energy = np.linalg.norm(x_full) ** 2
    rel_full = np.sqrt(max(energy - np.sum(s_host[:8] ** 2), 0.0) / energy)
    assert rel_inc <= rel_full + 0.02, (rel_inc, rel_full)
    assert updated["V"].sizes["time"] == x_full.shape[1]
    np.testing.assert_allclose(s_inc, out["jax"][0]["s"].values, rtol=1e-4)


def test_select_new_snapshots_matches_jax(root, base_config):
    """The boundary snapshots the embedding needs, the same times as the
    JAX selection; None once covered; too short a slice raises."""
    root("port")
    _stage_slice(_port_stage(), base_config, seed=5)
    results = era5_svd.main(dict(base_config), device="cpu")[0]
    ext = create_mock_era5("2019-09-01T00", "2019-09-02T06", ["temperature"], [1000], seed=5)
    ext_j = mock_jax("2019-09-01T00", "2019-09-02T06", ["temperature"], [1000], seed=5)
    got = era5_svd_update.select_new_snapshots(ext, results)
    ref = stage_update_jax.select_new_snapshots(ext_j, results)
    np.testing.assert_array_equal(got.coord("time").values, ref.coord("time").values)
    assert got.sizes["time"] == 6 + 1
    assert era5_svd_update.select_new_snapshots(ext.isel(time=slice(0, 25)), results) is None
    with pytest.raises(ValueError, match="boundary"):
        era5_svd_update.select_new_snapshots(ext.isel(time=slice(25, 31)), results)


# ------------------------------------------------- the onepass backend

def test_onepass_backend_through_the_stage(root):
    """test_20:208: ``svd_backend = onepass`` through ``era5_svd.main``:
    the backend and ``onepass_tail_rel_err_est`` in the attrs (as the JAX
    stage stamps them), U's shape, the reconstruction of the embedded
    matrix within 1.6 x the optimal rank-k error (a sketch-and-solve
    estimate, so the bound and not factor parity)."""
    cfg = {"source_path": "gs://mock", "delta_time": "1h", "variables": "temperature",
           "levels": "1000", "svd_type": "randomized", "delay_embedding": 2,
           "mean_center": True, "scale": False, "n_components": 8, "save_data_matrix": False,
           "start_datetime": "2021-05-01T00", "end_datetime": "2021-05-02T00",
           "svd_backend": "onepass"}
    out = {}
    for name, pkg in (("jax", _jax_stage()), ("port", _port_stage())):
        root(name)
        fs = _stage_slice(pkg, cfg, seed=7)
        extra = {"device": "cpu"} if name == "port" else {}
        out[name] = pkg[4].main(dict(cfg), write_artifact=False, **extra)[0]
    res, res_j = out["port"], out["jax"]
    assert res.attrs["svd_backend"] == res_j.attrs["svd_backend"] == "onepass"
    est = res.attrs["onepass_tail_rel_err_est"]
    assert isinstance(est, float) and est > 0 and "onepass_tail_rel_err_est" in res_j.attrs
    n_space, d, k = 36 * 72, 2, 8
    assert res["U"].shape == (n_space * d, k)
    std, _, _ = standardize_data(fs, scale=False)
    x = np.asarray(apply_delay_embedding(flatten_era5_variables(std), d).data, np.float64)
    u = res["U"].values.astype(np.float64)
    err = np.linalg.norm(x - u @ (u.T @ x))
    optimal = np.linalg.norm(np.linalg.svd(x, compute_uv=False)[k:])
    assert err <= 1.6 * optimal, (err, optimal)
