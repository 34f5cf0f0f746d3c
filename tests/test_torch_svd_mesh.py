"""Parity of the port's SVD layer on a mesh with the JAX package's.

The mesh cases of tests/test_03_svd.py (:149, :169, :220, :232, :265,
:279, :302, :324, :345) and tests/test_20_svd_backends.py (:154, :172),
and tests/test_21_comm_pattern.py's bounds (:123, :150, :177) read from
each rank's ``collective_log``: the port's ``ops.svd`` on P gloo ranks
(spawned once per P for the whole file, ``torch_mesh_ranks``), P in
{2, 3, 4} (4 as (1, 2, 2) for the grid cases), against the JAX
functions on the conftest's 8-device CPU mesh, at the JAX tests'
tolerances.  The randomized cases pass the JAX-drawn sketch to the
ranks, so both packages factor the same sketch.  U is gathered to the
host by ``parallel.assemble_rows``.
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_mesh_ranks import Ranks

from dmd_era5_tpu.core.config_parser import config_parser
from dmd_era5_tpu.ops import svd as jsvd
from dmd_era5_tpu.parallel import make_mesh as jmake_mesh
from dmd_era5_tpu.parallel import shard_rows as jshard_rows
from dmd_era5_tpu.pipeline import era5_download, era5_svd
from dmd_era5_tpu.snapmat import create_mock_era5, create_mock_era5_svd
from dmd_era5_tpu.utils.io_h5 import save_fieldset

WORLDS = (2, 3, 4)
ROOT_ENV = "DMD_ERA5_TPU_ROOT"


def lowrank_matrix(rng, s, t, rank, noise=1e-3):
    """test_03's tall matrix with a controlled spectrum."""
    a = rng.standard_normal((s, rank))
    b = rng.standard_normal((rank, t))
    x = (a * np.logspace(0, -2, rank)) @ b + noise * rng.standard_normal((s, t))
    return x.astype(np.float32)


def subspace_angle_err(a: np.ndarray, b: np.ndarray) -> float:
    """test_03's max principal angle, as 1 - min cosine."""
    qa, _ = np.linalg.qr(a)
    qb, _ = np.linalg.qr(b)
    return float(1.0 - np.linalg.svd(qa.T @ qb, compute_uv=False).min())


def principal_angle(u_a: np.ndarray, u_b: np.ndarray) -> float:
    """test_20's largest principal angle (rad)."""
    qa, _ = np.linalg.qr(u_a)
    qb, _ = np.linalg.qr(u_b)
    return float(np.arccos(np.clip(np.linalg.svd(qa.T @ qb, compute_uv=False).min(), -1, 1)))


def jax_omega(seed: int, t: int, r: int) -> np.ndarray:
    """The sketch the JAX randomized SVDs draw from ``seed``."""
    return np.asarray(jax.random.normal(jax.random.key(seed), (t, r), dtype=jnp.float32))


@contextmanager
def stage_root(path):
    """Point both packages' workdir at ``path`` (read at every call)."""
    before = os.environ.get(ROOT_ENV)
    os.environ[ROOT_ENV] = str(path)
    try:
        yield
    finally:
        os.environ[ROOT_ENV] = before


STAGE_BASE = {
    "source_path": "gs://mock", "delta_time": "1h", "variables": "temperature",
    "levels": "1000", "delay_embedding": 2, "mean_center": True, "scale": False,
    "n_components": 8, "save_data_matrix": False,
}
STANDARD = {**STAGE_BASE, "start_datetime": "2021-08-01T00", "end_datetime": "2021-08-02T00",
            "svd_type": "standard", "svd_backend": "hankel"}
TIME_SHARDED = {**STAGE_BASE, "start_datetime": "2021-02-01T00",
                "end_datetime": "2021-02-02T00", "svd_type": "randomized",
                "svd_backend": "hankel"}


def stage_slice(cfg: dict, plant: bool) -> None:
    """test_20's mock slice (seed 7) into the workdir; with ``plant`` a
    rank-10 signal on its i.i.d. noise, so that the two packages'
    different sketches find the same leading subspace."""
    parsed = config_parser(dict(cfg), "era5-svd")
    fs = create_mock_era5(parsed["start_datetime"], parsed["end_datetime"],
                          parsed["variables"], parsed["levels"], seed=7)
    if plant:
        field = fs["temperature"]
        n_time, n_space = field.data.shape[0], int(np.prod(field.data.shape[1:]))
        rng = np.random.default_rng(11)
        u0, _ = np.linalg.qr(rng.standard_normal((n_space, 10)))
        v0, _ = np.linalg.qr(rng.standard_normal((n_time, 10)))
        signal = (v0 * np.geomspace(8000.0, 3000.0, 10)) @ u0.T
        fs.data_vars["temperature"] = field.copy(
            data=field.data + signal.reshape(field.data.shape))
    save_fieldset(era5_download.add_config_attributes(fs, parsed), parsed["era5_slice_path"])


def _inputs(p: int) -> dict:
    rng = np.random.default_rng(0)
    _, _, _, _, mock = create_mock_era5_svd("2020-01-01", "2020-01-02", delay_embedding=2,
                                            n_components=10, seed=42)
    out = {
        "exact": lowrank_matrix(rng, 1024, 32, rank=12),
        "recon": lowrank_matrix(rng, 2048, 24, rank=6, noise=0.0),
        "rand": lowrank_matrix(rng, 1024, 64, rank=10, noise=1e-4),
        "single": lowrank_matrix(rng, 1024, 32, rank=8, noise=1e-4),
        "mock": np.asarray(mock.data, dtype=np.float32),
        "comm_exact": rng.standard_normal((4096, 32)).astype(np.float32),
        "comm_rand": rng.standard_normal((4096, 64)).astype(np.float32),
        "grid": lowrank_matrix(rng, 1024, 64, rank=10, noise=1e-4),
        "time": lowrank_matrix(rng, 512, 64, rank=6, noise=1e-4),
        "comm_grid": rng.standard_normal((2048, 64)).astype(np.float32),
    }
    out.update(omega_rand=jax_omega(0, 64, 20), omega_single=jax_omega(3, 32, 16),
               omega_bf16=jax_omega(0, 32, 16), omega_comm=jax_omega(0, 64, 18),
               omega_grid=jax_omega(2, 64, 18), omega_time=jax_omega(0, 64, 16))
    return out


def _cases(p: int) -> list[dict]:
    def case(name, fn, **args):
        return {"name": name, "fn": fn, "args": args}

    cases = [
        case("exact", "svd_case", op="exact", x="exact", k=8),
        case("gram", "svd_case", op="gram", x="exact", k=8),
        case("standard", "svd_case", op="standard", x="exact", k=8),
        case("recon", "svd_case", op="exact", x="recon", k=6),
        case("rand", "svd_case", op="randomized", x="rand", k=10, omega="omega_rand"),
        case("single", "svd_case", op="randomized", x="single", k=6, omega="omega_single"),
        case("bf16", "svd_case", op="randomized", x="single", k=6, omega="omega_bf16",
             gemm="bfloat16"),
        case("mock", "svd_case", op="exact", x="mock", k=10),
        case("comm_exact", "svd_case", op="standard", x="comm_exact", k=8),
        case("comm_rand", "svd_case", op="randomized", x="comm_rand", k=8, omega="omega_comm"),
        case("stage_standard", "stage_case",
             config=json.dumps({**STANDARD, "mesh_shape": f"space={p}"})),
    ]
    if p in (2, 4):
        cases.append(case("time", "grid_case", op="svd2d", x="time", k=6, shape=f"time={p}",
                          omega="omega_time"))
    if p == 4:
        grid = "data=1,space=2,time=2"
        cases += [
            case("grid", "grid_case", op="svd2d", x="grid", k=8, shape=grid, omega="omega_grid"),
            case("comm_grid", "grid_case", op="svd2d", x="comm_grid", k=8, shape=grid,
                 omega="omega_comm"),
            case("stage_time", "stage_case",
                 config=json.dumps({**TIME_SHARDED, "mesh_shape": "space=2,time=2"})),
        ]
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's ranks, started together at once, each under a root
    of its own with the stage's slices in its workdir."""
    base = tmp_path_factory.mktemp("svd_mesh")
    out = {}
    for p in WORLDS:
        root = base / f"p{p}" / "root"
        with stage_root(root):
            stage_slice(STANDARD, plant=False)
            stage_slice(TIME_SHARDED, plant=True)
        out[p] = Ranks(p, _cases(p), _inputs(p), base / f"p{p}", timeout=240,
                       extra_env={ROOT_ENV: str(root)})
    return out, _inputs(2), base


@pytest.fixture(scope="module")
def jax_mesh():
    return jmake_mesh()  # 8 virtual CPU devices on the space axis


def _outs(worlds, p):
    return worlds[0][p].wait()


def _alike(outs, name: str, keys=("u", "s", "v")):
    """s and V are alike on every rank, and so is the gathered U."""
    for o in outs[1:]:
        for key in keys:
            np.testing.assert_array_equal(o[f"{name}/{key}"], outs[0][f"{name}/{key}"])
    return outs[0]


def _numpy_svd_check(got, name, x, k, s_rtol=2e-3, atol=5e-3):
    """test_03's exact-route oracle: s, and U and V up to sign."""
    u_np, s_np, vt_np = np.linalg.svd(x, full_matrices=False)
    np.testing.assert_allclose(got[f"{name}/s"], s_np[:k], rtol=s_rtol)
    for j in range(k):
        uj = got[f"{name}/u"][:, j]
        sign = np.sign(np.dot(uj, u_np[:, j]))
        np.testing.assert_allclose(uj * sign, u_np[:, j], atol=atol)
        np.testing.assert_allclose(got[f"{name}/v"][j] * sign, vt_np[j], atol=atol)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("name,route", [("exact", jsvd.exact_truncated_svd),
                                        ("gram", jsvd.exact_truncated_svd_gram)])
def test_exact_routes_match_numpy_and_jax(worlds, jax_mesh, p, name, route):
    """test_03:149 and :169: both exact routes on the mesh against numpy
    and the JAX route on the 8-device mesh; the Gram route's U^T U."""
    x = worlds[1]["exact"]
    got = _alike(_outs(worlds, p), name)
    _numpy_svd_check(got, name, x, 8)
    xs, _ = jshard_rows(x, jax_mesh)
    ref = route(xs, 8, mesh=jax_mesh)
    np.testing.assert_allclose(got[f"{name}/s"], np.asarray(ref.s), rtol=2e-3)
    assert subspace_angle_err(got[f"{name}/u"], np.asarray(ref.U)[:1024]) < 1e-3
    if name == "gram":
        u = got["gram/u"]
        np.testing.assert_allclose(u.T @ u, np.eye(8), atol=1e-4)
        # the dispatcher's auto route on the whole matrix's shape is the
        # Gram one (its first pass bf16-split, the JAX default there)
        np.testing.assert_allclose(_outs(worlds, p)[0]["standard/s"], got["gram/s"], rtol=1e-5)


@pytest.mark.parametrize("p", WORLDS)
def test_exact_svd_reconstruction(worlds, p):
    """test_03:220: U diag(s) V rebuilds the rank-6 matrix."""
    got = _alike(_outs(worlds, p), "recon")
    recon = got["recon/u"] @ np.diag(got["recon/s"]) @ got["recon/v"]
    np.testing.assert_allclose(recon, worlds[1]["recon"], atol=1e-3)


@pytest.mark.parametrize("p", WORLDS)
def test_randomized_svd_subspace(worlds, jax_mesh, p):
    """test_03:232 (s rtol 1e-2, subspace angles < 1e-3 against numpy)
    and :265 (the mesh against one device on the same sketch: s rtol
    1e-3, U atol 5e-3) against the JAX SVD on the same sketch."""
    outs = _outs(worlds, p)
    x = worlds[1]["rand"]
    got = _alike(outs, "rand")
    u_np, s_np, vt_np = np.linalg.svd(x, full_matrices=False)
    np.testing.assert_allclose(got["rand/s"], s_np[:10], rtol=1e-2)
    assert subspace_angle_err(got["rand/u"], u_np[:, :10]) < 1e-3
    assert subspace_angle_err(got["rand/v"].T, vt_np[:10].T) < 1e-3
    xs, _ = jshard_rows(x, jax_mesh)
    ref = jsvd.randomized_svd(xs, 10, mesh=jax_mesh, seed=0)
    np.testing.assert_allclose(got["rand/s"], np.asarray(ref.s), rtol=1e-3)
    np.testing.assert_allclose(got["rand/u"], np.asarray(ref.U)[:1024], atol=5e-3)

    one = _alike(outs, "single")
    ref1 = jsvd.randomized_svd(jnp.asarray(worlds[1]["single"]), 6, seed=3)
    np.testing.assert_allclose(one["single/s"], np.asarray(ref1.s), rtol=1e-3)
    np.testing.assert_allclose(one["single/u"], np.asarray(ref1.U), atol=5e-3)


@pytest.mark.parametrize("p", WORLDS)
def test_randomized_bf16_gemm_path(worlds, p):
    """test_03:279: bf16 products, s rtol 2e-2 and the subspace within
    5e-2 of numpy's."""
    got = _alike(_outs(worlds, p), "bf16")
    u_np, s_np, _ = np.linalg.svd(worlds[1]["single"], full_matrices=False)
    np.testing.assert_allclose(got["bf16/s"], s_np[:6], rtol=2e-2)
    assert subspace_angle_err(got["bf16/u"], u_np[:, :6]) < 5e-2


@pytest.mark.parametrize("p", WORLDS)
def test_mock_era5_oracle_parity(worlds, p):
    """test_03:302: the mock's delay-embedded X through the meshed exact
    SVD against the host oracle (s rtol 1e-3, U atol 2e-2)."""
    got = _alike(_outs(worlds, p), "mock")
    u_o, s_o, _ = np.linalg.svd(worlds[1]["mock"].astype(np.float64), full_matrices=False)
    np.testing.assert_allclose(got["mock/s"], s_o[:10], rtol=1e-3)
    for j in range(10):
        uj = got["mock/u"][:, j]
        sign = np.sign(np.dot(uj, u_o[:, j]))
        np.testing.assert_allclose(uj * sign, u_o[:, j], atol=2e-2)


def test_randomized_svd_2d_grid_sharded(worlds):
    """test_03:324 on (1, 2, 2): s within 1e-3 of the one-device JAX SVD
    on the same sketch, the subspace within 1e-3 of numpy's."""
    from dmd_era5_tpu.ops.svd import randomized_svd_2d

    got = _alike(_outs(worlds, 4), "grid")
    x = worlds[1]["grid"]
    ref = jsvd.randomized_svd(jnp.asarray(x), 8, seed=2)
    np.testing.assert_allclose(got["grid/s"], np.asarray(ref.s), rtol=1e-3)
    assert subspace_angle_err(got["grid/u"], np.linalg.svd(x, full_matrices=False)[0][:, :8]) < 1e-3
    mesh2d = jmake_mesh("space=4,time=2")
    res = randomized_svd_2d(jax.device_put(jnp.asarray(x), NamedSharding(mesh2d, P("space", "time"))),
                            8, mesh=mesh2d, seed=2)
    np.testing.assert_allclose(got["grid/s"], np.asarray(res.s), rtol=1e-3)


@pytest.mark.parametrize("p", [2, 4])
def test_randomized_svd_2d_time_only(worlds, p):
    """test_03:345: every rank on the time axis; s within 1e-2 of numpy's."""
    got = _alike(_outs(worlds, p), "time")
    s_host = np.linalg.svd(worlds[1]["time"], compute_uv=False)[:6]
    np.testing.assert_allclose(got["time/s"], s_host, rtol=1e-2)


PSUM, ALL_GATHER, PPERMUTE, ALL_TO_ALL = 0, 1, 2, 3  # torch_mesh_ranks' op codes


@pytest.mark.parametrize("p", WORLDS)
def test_exact_and_randomized_collectives_are_small(worlds, p):
    """test_21:150 (the exact route: nothing past 2 T^2) and :177 (the
    randomized SVD: nothing past max(2 r T, 4 r^2)), on every rank."""
    for o in _outs(worlds, p):
        log = o["comm_exact/log"]
        assert len(log) and log[:, 2].max() <= 2 * 32 * 32, log
        log = o["comm_rand/log"]
        r = 8 + 10
        assert len(log) and log[:, 2].max() <= max(2 * r * 64, 4 * r * r), log
        assert not (log[:, 0] == ALL_GATHER).any()


def test_grid2d_randomized_svd_collectives_are_small(worlds):
    """test_21:123 on (1, 2, 2): the sketch's sum over time moves
    (S_loc, r); nothing bigger crosses a rank."""
    r = 8 + 10
    for o in _outs(worlds, 4):
        log = o["comm_grid/log"]
        assert len(log) and log[:, 2].max() <= (2048 // 2) * r, log


def _jax_stage(cfg: dict, root, plant: bool):
    with stage_root(root):
        stage_slice(cfg, plant=plant)
        return era5_svd.main(dict(cfg), write_artifact=False)[0]


@pytest.mark.parametrize("p", WORLDS)
def test_hankel_standard_space_sharded(worlds, p, tmp_path):
    """test_20:154: the exact Hankel path with ``mesh_shape = space=P``
    through the stage matches the JAX stage (s rtol 1e-4, angle < 5e-3)."""
    ref = _jax_stage(STANDARD, tmp_path, plant=False)
    outs = _outs(worlds, p)
    got = _alike(outs, "stage_standard", keys=("U", "s", "V"))
    for o in outs:
        assert str(o["stage_standard/backend"]) == "hankel"
    np.testing.assert_allclose(got["stage_standard/s"], ref["s"].values, rtol=1e-4)
    assert principal_angle(got["stage_standard/U"], ref["U"].values) < 5e-3


def test_hankel_time_sharded_matches_jax(worlds, tmp_path):
    """test_20:172 on (1, 2, 2): the Hankel backend on a space x time
    grid through the stage (no host embedding; the planted slice)
    against the JAX stage on space=2, time=4: s rtol 2e-3, angle < 5e-2,
    U^T U within 1e-3."""
    ref = _jax_stage({**TIME_SHARDED, "mesh_shape": "space=2,time=4"}, tmp_path, plant=True)
    got = _alike(_outs(worlds, 4), "stage_time", keys=("U", "s", "V"))
    assert str(got["stage_time/backend"]) == "hankel" and "stage_time/X" not in got
    u = got["stage_time/U"]
    assert u.shape == ref["U"].values.shape
    np.testing.assert_allclose(got["stage_time/s"], ref["s"].values, rtol=2e-3)
    assert principal_angle(u, ref["U"].values) < 5e-2
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), atol=1e-3)
