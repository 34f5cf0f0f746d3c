"""Parity of the port's DMD models on a mesh with the JAX package's.

The port's ranks (``torch_mesh_ranks``: worlds of 2, 3 and 4 gloo
processes on the CPU, spawned once for the file) against the JAX package
on the conftest's 8 virtual CPU devices and the port on one device:

- tests/test_23_bopdmd.py's EP cases (:125-185): the bag over ``data=2``
  and ``data=4`` with 10 trials (the axis does not divide 10), against
  JAX meshed ``bopdmd_from_svd`` and the port on one device; its
  collective log: nothing in the solve, one gather over ``data``;
- tests/test_14_ensemble.py's three mesh cases (:15-90) on
  ``data=2,space=2`` against JAX meshed ``fit_per_variable_level`` (the
  JAX-drawn sketch passed as ``omega=``), and a padded batch read from
  memmaps against the port on one device;
- DMDc (tests/test_27_dmdc.py's forced system and test_27's
  tolerances) over ``space=2`` against JAX meshed ``fit_dmdc`` (the rows
  divide the axis) and over ``space=3`` against the port on one device
  (they do not: zero rows pad them), ``dmdc_from_svd`` too;
- tests/test_11_dmd_stage.py's bagged stage on a mesh (:162-172):
  ``era5_dmd.main`` on ``data=2,space=2`` over 4 ranks, the artifact
  written and versioned by rank 0 alone, and on the planted slice with a
  diurnal control against the JAX stage on ``data=4,space=2``; a failed
  write of rank 0 raised on every rank;
- ``__graft_entry__.dryrun_multichip``'s EP BOP-DMD path (:158-187) at
  ``data=P``.
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_05_dmd import matched_eig_error
from test_11_dmd_stage import _stage_slice, _stage_slice_dynamic
from test_23_bopdmd import TRUE_ALPHAS, _oscillator_data
from test_27_dmdc import _forced_system
from test_torch_dmdc import _lifted
from test_torch_ensemble import _planted
from test_torch_io_h5 import to_jax
from test_torch_optdmd import _match
from torch_mesh_ranks import Ranks

from dmd_era5_tpu.core.config_parser import config_parser
from dmd_era5_tpu.models import bopdmd as bop_jax
from dmd_era5_tpu.models import dmdc as dmdc_jax
from dmd_era5_tpu.parallel import make_mesh as jmake_mesh
from dmd_era5_tpu.pipeline import era5_dmd as dmd_jax
from dmd_era5_tpu.pipeline.ensemble import fit_per_variable_level as fit_jax
from dmd_era5_tpu_torch.models import bopdmd_from_svd, dmdc_from_svd, fit_dmdc
from dmd_era5_tpu_torch.pipeline import fit_per_variable_level
from dmd_era5_tpu_torch.pipeline.artifacts import list_versions
from dmd_era5_tpu_torch.snapmat import create_mock_era5
from dmd_era5_tpu_torch.utils.io_h5 import load_fieldset

WORLDS = (2, 3, 4)
ROOT_ENV = "DMD_ERA5_TPU_ROOT"
PSUM, ALL_GATHER = 0, 1  # op codes of torch_mesh_ranks' logs
DATA, SPACE = 0, 1  # axis codes
BAG = dict(rank=4, n_trials=10, trial_fraction=0.7, seed=9, max_iter=30)  # test_23 :131
STAGE = {  # tests/test_11_dmd_stage.py's dmd_config, bagged as at :162
    "source_path": "gs://mock-bucket/era5.zarr", "start_datetime": "2019-05-01T00",
    "end_datetime": "2019-05-02T00", "delta_time": "1h", "variables": "temperature",
    "levels": "1000", "svd_type": "standard", "delay_embedding": 2, "mean_center": True,
    "scale": False, "n_components": 8, "save_data_matrix": True, "dmd_rank": 6,
    "optimized": True, "forecast_steps": 6, "lm_max_iter": 30, "bagging_trials": 8,
}
# the planted slice's window at rank 4, bagged as test_torch_dmd_stage's
# bagged path
PLANTED = dict(STAGE, start_datetime="2019-06-01T00", end_datetime="2019-06-03T00",
               dmd_rank=4, bagging_trials=6, bagging_fraction=0.75)
# test_14's three mesh cases: (variables, levels, mock seed, k, sketch seed);
# solve_dmd's on test_torch_ensemble's planted fields (on the i.i.d. mock
# the LM chases noise, and a batch of one stops elsewhere than a batch of
# two: ROADMAP Queue 3)
ENSEMBLES = {
    "labels": (["temperature", "u_component_of_wind"], [1000, 850, 500], 4, 4, 0),
    "separate": (["temperature"], [1000, 500], 6, 3, 9),
    "solve": (["temperature"], [1000, 500], 6, 4, 9),
}


def _ensemble_fields(name: str):
    variables, levels, seed, *_ = ENSEMBLES[name]
    fs = create_mock_era5("2020-01-01", "2020-01-01T23", variables, levels, seed=seed)
    return _planted(fs) if name == "solve" else fs


@contextmanager
def stage_root(path):
    """Point both packages' workdir at ``path`` (read at every call)."""
    before = os.environ.get(ROOT_ENV)
    os.environ[ROOT_ENV] = str(path)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(ROOT_ENV)
        else:
            os.environ[ROOT_ENV] = before


def jax_omega(seed: int, t: int, r: int) -> np.ndarray:
    """The sketch the JAX ensemble draws from ``seed``."""
    return np.asarray(jax.random.normal(jax.random.key(seed), (t, r), dtype=jnp.float32))


def _oscillator_factors(noise=0.01):
    x, t = _oscillator_data(noise=noise)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    return u[:, :4].copy(), s[:4].copy(), vt[:4].copy(), t


def _dryrun_factors(n: int):
    """``dryrun_multichip(n)``'s EP bag inputs (:163-180): its rng is
    ``default_rng(0)`` after the earlier draws, so the port draws its own
    (96 x 2) patterns from seed 0 of the same shape."""
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 2.0, 24).astype(np.float32)
    dyn = np.exp(np.outer(t, [-0.1, -0.4])) * np.cos(np.outer(t, [3.0, 7.0]))
    x = (rng.standard_normal((96, 2)) @ dyn.T).astype(np.float32)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    return u[:, :4].copy(), s[:4].copy(), vt[:4].copy(), t


def _fields(prefix: str, fs) -> dict:
    out = {f"{prefix}.coord.{name}": np.asarray(fs.coord(name).values)
           for name in ("time", "level", "latitude", "longitude")}
    for name in fs.variables:
        out[f"{prefix}.var.{name}"] = np.asarray(
            fs[name].transpose("time", "level", "latitude", "longitude").values, np.float32)
    return out


def _inputs() -> dict:
    u, s, v, t = _oscillator_factors()
    x, u_seq, *_ = _forced_system()
    out = {"bag_u": u, "bag_s": s, "bag_v": v, "bag_t": t, "x": x, "u_seq": u_seq}
    uu, ss, vv = np.linalg.svd(x, full_matrices=False)  # test_27 :139's factors
    out.update(x_u=uu[:, :10].copy(), x_s=ss[:10].copy(), x_v=vv[:10].copy())
    for p in WORLDS:
        du, ds, dv, dt = _dryrun_factors(p)
        out.update({f"dry{p}_u": du, f"dry{p}_s": ds, f"dry{p}_v": dv, f"dry{p}_t": dt})
    for name, (*_, k, omega_seed) in ENSEMBLES.items():
        fs = _ensemble_fields(name)
        out.update(_fields(name, fs))
        out[f"{name}_omega"] = jax_omega(omega_seed, fs.sizes["time"], k + 10)
    out["padded_omega"] = jax_omega(5, 24, 14)
    rng = np.random.default_rng(2)
    h = (rng.standard_normal((3, 12, 3)) + 1j * rng.standard_normal((3, 12, 3)))
    h[1] = np.inf
    out.update(lm_h=h.astype(np.complex64), lm_t=np.arange(12, dtype=np.float32),
               lm_alpha0=np.full((3, 2), -0.1 + 0.5j, np.complex64))
    return out


def _padded_fields(directory) -> dict:
    """A batch of 3 members (one variable at 3 levels; data=2 pads it to
    4) as (level, lat, lon, time) ``.npy`` files the ranks open as
    memmaps, and their coordinates."""
    fs = create_mock_era5("2020-01-01", "2020-01-01T23", ["temperature"], [1000, 850, 500],
                          seed=11)
    directory.mkdir(parents=True, exist_ok=True)
    for name in fs.variables:
        np.save(directory / f"{name}.npy", np.ascontiguousarray(np.asarray(
            fs[name].transpose("level", "latitude", "longitude", "time").values, np.float32)))
    return fs


def _cases(p: int, base) -> list[dict]:
    def case(name, fn, **args):
        return {"name": name, "fn": fn, "args": args}

    bag = dict(u="bag_u", s="bag_s", v="bag_v", t="bag_t", **BAG)
    cases = [case("dryrun", "bag_case", shape=f"data={p}", u=f"dry{p}_u", s=f"dry{p}_s",
                  v=f"dry{p}_v", t=f"dry{p}_t", rank=4, n_trials=2 * p, trial_fraction=0.9)]
    if p in (2, 4):
        cases.append(case("bag", "bag_case", shape=f"data={p}", **bag))
    if p in (2, 3):
        cases += [case("dmdc", "dmdc_case", shape=f"space={p}", x="x", u="u_seq", rank=4),
                  case("dmdc_svd", "dmdc_case", shape=f"space={p}", x="x", u="u_seq", rank=4,
                       factors=True)]
    if p == 4:
        grid = "data=2,space=2"
        cases += [case(name, "ensemble_case", shape=grid, fields=name, k=spec[3],
                       omega=f"{name}_omega", solve_dmd=name == "solve", dmd_max_iter=15)
                  for name, spec in ENSEMBLES.items()]
        cases += [
            case("padded", "ensemble_case", shape=grid, fields="padded", k=4,
                 omega="padded_omega", memmap=str(base / "memmap")),
            case("stage", "dmd_stage_case", config=json.dumps(dict(STAGE, control_input="diurnal")),
                 shape=grid, use_store=True),
            case("planted", "dmd_stage_case", config=json.dumps(PLANTED), shape=grid),
        ]
    if p == 2:
        cases += [case("diverged", "lm_case", shape="data=2", h="lm_h", t="lm_t",
                       alpha0="lm_alpha0", max_iter=5),
                  case("write_fails", "dmd_stage_case", config=json.dumps(STAGE), shape=None,
                       root=str(base / "fail_root"))]
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's ranks, started together at once, each under a root
    of its own with the stage's slices in its workdir; the JAX stage's
    slices under roots of their own."""
    base = tmp_path_factory.mktemp("models_mesh")
    inputs = _inputs()
    padded = _padded_fields(base / "memmap")
    inputs.update({key: value for key, value in _fields("padded", padded).items()
                   if ".coord." in key})
    for name in ("stage", "planted", "fail_root"):
        with stage_root(base / name):
            _stage_slice(dict(STAGE))  # the control keys no slice
            _stage_slice_dynamic(dict(PLANTED))
    (base / "fail_root" / "data" / "era5_dmd").write_text("not a directory")
    out = {}
    for p in WORLDS:
        out[p] = Ranks(p, _cases(p, base), inputs, base / f"p{p}", timeout=240,
                       extra_env={ROOT_ENV: str(base / "stage" if p == 4 else base / f"r{p}")})
    return out, inputs, base, padded


def _outs(worlds, p):
    return worlds[0][p].wait()


def _alike(outs, name: str):
    """Every rank returned the same values for ``name``."""
    keys = [key for key in outs[0] if key.startswith(f"{name}/") and not key.endswith("/log")
            and not key.endswith("/added")]
    for o in outs[1:]:
        for key in keys:
            np.testing.assert_array_equal(o[key], outs[0][key], err_msg=key)
    return {key.split("/", 1)[1]: outs[0][key] for key in keys}


def _assert_gathers_only_over_data(outs, name: str):
    """The bag's solve emits no collective: the one call of each rank's
    log is the gather of the packed results over ``data``."""
    for o in outs:
        log = o[f"{name}/log"]
        assert log.shape[0] == 1 and log[0, 0] == ALL_GATHER and log[0, 1] == DATA, log


# --------------------------------------------------- tests/test_23_bopdmd.py


def test_dmd_stage_planted_on_mesh_matches_jax_stage(worlds):
    """The planted slice, bagged (6 trials), on data=2,space=2 over 4
    ranks, against the JAX stage on data=4,space=2 (test_11 :168's mesh)
    at test_torch_dmd_stage's tolerances.  (First in the file: the JAX
    stage runs while the ranks do.)"""
    with stage_root(worlds[2] / "planted"):
        res_j, _, _ = dmd_jax.main(dict(PLANTED), mesh=jmake_mesh("data=4,space=2"))
    got = _alike(_outs(worlds, 4), "planted")
    eig, eig_j = got["eigenvalues"], res_j["eigenvalues"].values
    idx = _match(eig, eig_j)
    np.testing.assert_allclose(eig[idx], eig_j, atol=1e-5 * np.abs(eig_j).max())
    np.testing.assert_allclose(got["amplitudes"][idx], res_j["amplitudes"].values, rtol=1e-3)
    np.testing.assert_allclose(got["modes"][:, idx], res_j["modes"].values, atol=1e-4)
    fc_j = res_j["forecast"].values
    np.testing.assert_allclose(got["forecast"], fc_j, rtol=0, atol=1e-5 * np.abs(fc_j).max())
    assert int(got["trials_used"]) == res_j.attrs["bagging_trials_used"] == 6
    for name in ("eigenvalues_std", "amplitudes_std"):
        a, b = got[name][idx], res_j[name].values
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), name


@pytest.mark.parametrize("p", [2, 4])
def test_bag_sharded_over_data_axis_matches_unsharded(worlds, p):
    """test_23 :128: the bag over ``data`` (10 trials: padded to 12 at
    data=4) against the port's one-device bag at test_23's tolerances,
    and against JAX's meshed bag at the cross-package ones
    (test_torch_bopdmd's: eigenvalues 1e-3)."""
    inputs = worlds[1]
    u, s, v, t = (inputs[f"bag_{key}"] for key in "usvt")
    ref = bop_jax.bopdmd_from_svd(*(jnp.asarray(a) for a in (u, s, v, t)),
                                  mesh=jmake_mesh(f"data={p}"), **BAG)
    one = bopdmd_from_svd(*(torch.from_numpy(a) for a in (u, s, v, t)), **BAG)
    got = _alike(_outs(worlds, p), "bag")
    np.testing.assert_allclose(np.sort_complex(got["eigenvalues"]),
                               np.sort_complex(one.eigenvalues.numpy()), atol=1e-5)
    np.testing.assert_allclose(got["amplitudes"], one.amplitudes.numpy(), rtol=1e-4)
    np.testing.assert_allclose(got["trial_eigenvalues"], one.trial_eigenvalues.numpy(), atol=1e-5)
    np.testing.assert_array_equal(got["n_iters"], one.n_iters.numpy())
    np.testing.assert_allclose(got["modes"], one.modes.numpy(), atol=1e-5)
    idx = _match(got["eigenvalues"], np.asarray(ref.eigenvalues))
    np.testing.assert_allclose(got["eigenvalues"][idx], ref.eigenvalues, atol=1e-3)
    np.testing.assert_allclose(got["amplitudes"][idx], ref.amplitudes, rtol=1e-3)
    assert len(got["trial_eigenvalues"]) == len(ref.trial_eigenvalues) == 10
    assert matched_eig_error(got["eigenvalues"], TRUE_ALPHAS) < 0.05


@pytest.mark.parametrize("p", [2, 4])
def test_sharded_bag_emits_no_collectives_but_the_gather(worlds, p):
    """test_23 :146: trials are independent, so the solve crosses no rank;
    only the results' one gather over ``data`` does (the JAX program
    gathers outside ``shard_map``), of 10 trials padded to the axis."""
    outs = _outs(worlds, p)
    _assert_gathers_only_over_data(outs, "bag")
    per = -(-10 // p)
    for o in outs:
        assert o["bag/log"][0, 2] % (per * p) == 0  # the gathered (padded) batch's elements


def test_bag_non_finite_trials_cross_the_gather(worlds):
    """A diverged member's inf and NaN cross the gather over ``data=2``
    unchanged, so the bag drops the same trials on a mesh as on one
    device: ``varpro_lm_batched`` on 3 members (padded to 4), the second
    one's data infinite."""
    from dmd_era5_tpu_torch.models import varpro_lm_batched

    inputs = worlds[1]
    got = _alike(_outs(worlds, 2), "diverged")
    one = varpro_lm_batched(inputs["lm_h"], inputs["lm_t"], inputs["lm_alpha0"], max_iter=5)
    for key, want in zip(("alpha", "b", "rel", "n_iters"), one):
        np.testing.assert_array_equal(np.isfinite(got[key]), np.isfinite(want), err_msg=key)
        assert got[key].shape == want.shape and got[key].dtype == want.dtype, key
        np.testing.assert_allclose(got[key], want, rtol=1e-6, atol=1e-6, err_msg=key)
    assert np.isfinite(got["alpha"][0]).all() and not np.isfinite(got["b"][1]).all()


@pytest.mark.parametrize("p", WORLDS)
def test_dryrun_multichip_ep_bopdmd(worlds, p):
    """``dryrun_multichip``'s EP bag on ``data=P`` (2 P trials of 90%):
    finite eigenvalues alike on every rank, the port's one-device bag on
    the same factors, and no collective but the gather."""
    outs = _outs(worlds, p)
    got = _alike(outs, "dryrun")
    inputs = worlds[1]
    args = [torch.from_numpy(inputs[f"dry{p}_{key}"]) for key in "usvt"]
    one = bopdmd_from_svd(*args, rank=4, n_trials=2 * p, trial_fraction=0.9)
    assert np.isfinite(got["eigenvalues"]).all()
    np.testing.assert_allclose(np.sort_complex(got["eigenvalues"]),
                               np.sort_complex(one.eigenvalues.numpy()), atol=1e-5)
    _assert_gathers_only_over_data(outs, "dryrun")


# ------------------------------------------------- tests/test_14_ensemble.py


def _jax_fit(name: str, mesh: str, **kw):
    *_, k, omega_seed = ENSEMBLES[name]
    fs = _ensemble_fields(name)
    return fs, fit_jax(to_jax(fs), n_components=k, mesh=jmake_mesh(mesh), seed=omega_seed, **kw)


def _ensemble_state_matches(got: dict, ref, n: int, k: int):
    """test_torch_ensemble's parity: s to 1e-4 relative, the loss over the
    whole batch as the JAX step's, each U orthonormal to 2e-3 (test_14)
    and spanning the JAX member's, a_red up to the SVD's signs."""
    np.testing.assert_allclose(got["s"], np.asarray(ref.state.s), rtol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(ref.state.loss), atol=1e-4)
    for b in range(n):
        u, u_j = got["u"][b], np.asarray(ref.state.u)[b]
        np.testing.assert_allclose(u.T @ u, np.eye(k), atol=2e-3)
        assert np.linalg.svd(u.T @ u_j, compute_uv=False).min() > 1 - 1e-3
        d = np.diag(np.sign(np.sum(got["v"][b] * np.asarray(ref.state.v)[b], axis=1)))
        np.testing.assert_allclose(d @ got["a_red"][b] @ d, np.asarray(ref.state.a_red)[b],
                                   atol=5e-3)


def test_ensemble_labels_and_shapes(worlds):
    """test_14 :15, on data=2,space=2 over 4 ranks."""
    got = _alike(_outs(worlds, 4), "labels")
    _, ref = _jax_fit("labels", "data=2,space=4")
    assert len(got["labels"]) == 6
    assert got["labels"][0] == "temperature:1000" and got["labels"][3] == "u_component_of_wind:1000"
    assert got["u"].shape == (6, 36 * 72, 4) and got["s"].shape == (6, 4)
    assert got["a_red"].shape == (6, 4, 4) and got["v"].shape == (6, 4, 24)
    _ensemble_state_matches(got, ref, 6, 4)


def test_ensemble_matches_separate_fits(worlds):
    """test_14 :38: each member's s within 5e-2 of an independent host SVD."""
    got = _alike(_outs(worlds, 4), "separate")
    fs, ref = _jax_fit("separate", "data=2,space=2")
    arr = fs["temperature"].transpose("time", "level", "latitude", "longitude").values
    for li in range(2):
        x = arr[:, li].reshape(arr.shape[0], -1).T
        xc = x - x.mean(axis=1, keepdims=True)
        np.testing.assert_allclose(got["s"][li], np.linalg.svd(xc, compute_uv=False)[:3],
                                   rtol=5e-2)
    _ensemble_state_matches(got, ref, 2, 3)


def test_ensemble_solve_dmd(worlds):
    """test_14 :62: solve_dmd on the whole state (planted fields), against
    the port's per-member optDMD of the gathered factors (test_14's
    tolerances) and the JAX meshed batched solve (eigenvalues matched to
    1e-4, test_torch_ensemble's)."""
    from dmd_era5_tpu_torch.models import optdmd_from_svd
    from dmd_era5_tpu_torch.pipeline.era5_dmd import _hours_since_start

    got = _alike(_outs(worlds, 4), "solve")
    fs, ref = _jax_fit("solve", "data=2,space=2", solve_dmd=True, dmd_max_iter=15)
    _ensemble_state_matches(got, ref, 2, 4)
    assert got["dmd_alpha"].shape == (2, 4) and bool((got["dmd_residual"] >= 0).all())
    t_hours = _hours_since_start(np.asarray(fs.coord("time").values))
    for b in range(2):
        solo = optdmd_from_svd(*(torch.from_numpy(got[key][b]) for key in ("u", "s", "v")),
                               torch.from_numpy(t_hours), max_iter=15)
        idx = _match(got["dmd_alpha"][b], solo.alpha.numpy())
        np.testing.assert_allclose(got["dmd_alpha"][b][idx], solo.alpha.numpy(), atol=1e-4)
        np.testing.assert_allclose(got["dmd_amplitudes"][b][idx], solo.amplitudes.numpy(),
                                   rtol=1e-3, atol=1e-4)
        alpha_j = np.asarray(ref.dmd.alpha[b])
        idx = _match(got["dmd_alpha"][b], alpha_j)
        np.testing.assert_allclose(got["dmd_alpha"][b][idx], alpha_j, atol=1e-4)
        np.testing.assert_allclose(got["dmd_amplitudes"][b][idx],
                                   np.asarray(ref.dmd.amplitudes[b]), rtol=1e-3)


def test_ensemble_padded_batch_from_memmaps(worlds):
    """3 members over data=2 (a zero member pads the batch to 4, trimmed),
    each rank reading its block of read-only memmaps, against the port's
    one-device members through the meshed step's algebra: s to 1e-4
    relative, U's span; the loss over the real members (the zero one
    adds nothing)."""
    got = _alike(_outs(worlds, 4), "padded")
    fs = worlds[3]
    assert got["u"].shape == (3, 36 * 72, 4) and list(got["labels"]) == [
        "temperature:1000", "temperature:850", "temperature:500"]
    one = fit_per_variable_level(fs, 4, device="cpu", omega=worlds[1]["padded_omega"])
    np.testing.assert_allclose(got["s"], one.state.s.numpy(), rtol=1e-4)
    for b in range(3):
        qa, _ = np.linalg.qr(got["u"][b])
        qb, _ = np.linalg.qr(one.state.u[b].numpy())
        assert np.linalg.svd(qa.T @ qb, compute_uv=False).min() > 1 - 1e-3
    arr = fs["temperature"].transpose("level", "latitude", "longitude", "time").values
    num = den = 0.0
    for b in range(3):
        x = arr[b].reshape(-1, 24).astype(np.float64)
        xc = x - x.mean(axis=1, keepdims=True)
        num += (xc * xc).sum() - (got["s"][b].astype(np.float64) ** 2).sum()
        den += (xc * xc).sum()
    np.testing.assert_allclose(float(got["loss"]), np.sqrt(max(num, 0.0) / den), rtol=1e-3)


# ----------------------------------------------------- tests/test_27_dmdc.py


def _dmdc_port_one_device(factors: bool):
    x, u_seq, *_ = _forced_system()
    if factors:
        uu, ss, vv = np.linalg.svd(x, full_matrices=False)
        return dmdc_from_svd(torch.from_numpy(uu[:, :10].copy()),
                             torch.from_numpy(ss[:10].copy()),
                             torch.from_numpy(vv[:10].copy()), u_seq, rank=4)
    return fit_dmdc(x, u_seq, rank=4, device="cpu")


def _assert_dmdc_matches(got: dict, ref, u_true, a0, b0):
    """test_27's tolerances: the unforced spectrum within 2e-3 of eig(A0)
    and of the reference's (matched nearest first), the reduced input map
    within 5e-3 of the truth's, the reduced maps in full space within
    5e-3 of the reference's (test_torch_dmdc)."""
    lam = got["eigenvalues"]
    assert matched_eig_error(lam, np.linalg.eigvals(a0)) < 2e-3
    idx = _match(lam, np.asarray(ref.eigenvalues))
    np.testing.assert_allclose(lam[idx], ref.eigenvalues, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got["b_red"], (got["u_hat"].T @ u_true) @ b0, rtol=0, atol=5e-3)
    mine = (got["u_hat"].astype(np.float64) @ got["b_red"],
            got["u_hat"].astype(np.float64) @ got["a_red"] @ got["u_hat"].T)
    for a, b in zip(mine, _lifted(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-3)


@pytest.mark.parametrize("factors", [False, True], ids=["fit_dmdc", "dmdc_from_svd"])
def test_dmdc_over_space_2(worlds, factors):
    """space=2: [X1; gamma U] has 82 rows and X2 80, both divide the axis,
    so the JAX meshed fit_dmdc runs (its Gram SVDs shard_map'd over
    space): the port's ranks against it (``dmdc_from_svd``, whose k-sized
    fit test_torch_dmdc holds to the JAX one, against the port's one
    device); each Gram SVD's collectives: its three psums over space and
    U's gather."""
    x, u_seq, a0, b0, u_true = _forced_system()
    name = "dmdc_svd" if factors else "dmdc"
    if not factors:
        ref = dmdc_jax.fit_dmdc(x, u_seq, rank=4, mesh=jmake_mesh("space=2"))
    outs = _outs(worlds, 2)
    got = _alike(outs, name)
    if not factors:
        _assert_dmdc_matches(got, ref, u_true, a0, b0)
    one = _dmdc_port_one_device(factors)
    idx = _match(got["eigenvalues"], one.eigenvalues.numpy())
    np.testing.assert_allclose(got["eigenvalues"][idx], one.eigenvalues.numpy(), atol=1e-4)
    if factors:
        np.testing.assert_allclose(np.abs(got["modes"][:, idx]), np.abs(one.modes.numpy()),
                                   atol=1e-3)
    for o in outs:
        log = o[f"{name}/log"]
        assert (log[:, 1] == SPACE).all(), log
        assert (log[:, 0] == PSUM).sum() == 6 and (log[:, 0] == ALL_GATHER).sum() == 2, log


@pytest.mark.parametrize("factors", [False, True], ids=["fit_dmdc", "dmdc_from_svd"])
def test_dmdc_over_space_3_rows_not_dividing(worlds, factors):
    """space=3: X2's 80 rows (10 in the k-sized fit) do not divide the
    axis, which JAX's shard_map refuses; the port pads with zero rows, and
    its fit holds to its one-device fit: the spectrum to 1e-4, the
    reduced maps in full space to 5e-3 (test_27's), the lifted modes."""
    x, u_seq, a0, b0, u_true = _forced_system()
    got = _alike(_outs(worlds, 3), "dmdc_svd" if factors else "dmdc")
    one = _dmdc_port_one_device(factors)
    lam, lam1 = got["eigenvalues"], one.eigenvalues.numpy()
    idx = _match(lam, lam1)
    np.testing.assert_allclose(lam[idx], lam1, atol=1e-4)
    if factors:
        np.testing.assert_allclose(np.abs(got["modes"][:, idx]), np.abs(one.modes.numpy()),
                                   atol=1e-3)
    else:
        _assert_dmdc_matches(got, one, u_true, a0, b0)
    np.testing.assert_allclose(float(got["residual"]), one.residual, atol=1e-4)


# ------------------------------------------------- tests/test_11_dmd_stage.py


def test_dmd_stage_bagged_on_mesh(worlds):
    """test_11 :162: the bagged stage with a data-sharded mesh
    (data=2,space=2 over 4 ranks), a diurnal DMDc beside it: the bag's
    attrs, finite stds, every rank's FieldSet alike; rank 0 alone wrote
    and versioned the artifact, which holds its result."""
    outs = _outs(worlds, 4)
    got = _alike(outs, "stage")
    assert all(str(o["stage/error"]) == "" for o in outs)
    assert int(got["trials_used"]) >= 1
    assert np.isfinite(got["eigenvalues_std"]).all()
    # DMDc's SVDs over space=2: the fields of one device's schema, finite
    assert got["dmdc_a_red"].shape == (6, 6) and got["dmdc_modes"].shape == (36 * 72 * 2, 6)
    assert np.isfinite(got["dmdc_modes"]).all() and np.isfinite(got["dmdc_eigenvalues"]).all()
    assert [bool(o["stage/added"]) for o in outs] == [True, False, False, False]
    with stage_root(worlds[2] / "stage"):
        parsed = config_parser(dict(STAGE, control_input="diurnal"), "era5-dmd")
        saved = load_fieldset(parsed["save_path"])
        versions = list_versions(parsed["save_path"], data_type="era5_dmd")
    assert saved.attrs["bagging_trials"] == 8 and len(versions) == 1
    np.testing.assert_array_equal(saved["modes"].values, got["modes"])
    np.testing.assert_array_equal(saved["eigenvalues"].values, got["eigenvalues"])


def test_dmd_stage_rank0_write_failure_raises_on_every_rank(worlds):
    """Rank 0 alone writes the DMD artifact; where a file stands in the
    place of its directory, every rank of the world of 2 raises with rank
    0's error instead of waiting on it."""
    errors = [str(o["write_fails/error"]) for o in _outs(worlds, 2)]
    assert all("Error writing DMD results" in e for e in errors), errors
    assert "rank 0 failed" not in errors[0] and "rank 0 failed" in errors[1], errors
