"""The port's SVD stage and `dryrun_multichip`'s mesh paths over gloo ranks.

- tests/test_06_pipeline.py:409: ``era5_svd.main`` honours ``mesh_shape``
  from its config (space=2 over 2 ranks);
- tests/test_20_svd_backends.py:263: ``svd_backend = auto`` picks
  ``grid2d`` on a time-sharded mesh, and the grid2d stage route (each
  rank reads its 1/(space * time) of the rows, one ``all_to_all`` to the
  grid) against the JAX stage;
- tests/test_16_multiprocess.py's two demos (``scripts/multiprocess_demo.py``,
  ``scripts/multiprocess_stage_demo.py``) as gloo worlds of 2 and 3: the
  randomized SVD on each rank's own rows, and the stage's multi-process
  ``inmem`` route (rank 0 writes the packed ``.npy``, every rank reads its
  rows) against the host oracle;
- ``__graft_entry__.py::dryrun_multichip``'s Hankel-exact, exact-TSQR and
  grid2d paths (:99-157) at P = 2, 3, 4;
- the split CholQR2 leaf's fault on a row-centred panel (ROADMAP Queue 3)
  under the tree combine on 2 ranks: port and JAX off orthonormal alike.

Ranks: ``torch_mesh_ranks`` (spawned once per world for the whole file),
each world under a root of its own.
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from torch_mesh_ranks import Ranks

from dmd_era5_tpu.core.config_parser import config_parser
from dmd_era5_tpu.ops import hankel as jh
from dmd_era5_tpu.ops import svd as jsvd
from dmd_era5_tpu.ops.tsqr import tsqr as jtsqr
from dmd_era5_tpu.parallel import MESH_AXES
from dmd_era5_tpu.parallel import make_mesh as jmake_mesh
from dmd_era5_tpu.parallel import shard_rows as jshard_rows
from dmd_era5_tpu.parallel.sharding import grid_sharded
from dmd_era5_tpu.pipeline import era5_download, era5_svd
from dmd_era5_tpu.snapmat import create_mock_era5, flatten_era5_variables, standardize_data
from dmd_era5_tpu.snapmat.loader import load_row_sharded
from dmd_era5_tpu.snapmat.transform import delay_embed_np
from dmd_era5_tpu.utils.io_h5 import load_fieldset, save_fieldset

WORLDS = (2, 3, 4)
ROOT_ENV = "DMD_ERA5_TPU_ROOT"

STAGE_06 = {  # test_06's svd_stage_config at :409's window
    "source_path": "gs://mock-bucket/era5.zarr", "start_datetime": "2019-10-01T00",
    "end_datetime": "2019-10-01T18", "delta_time": "1h", "variables": "temperature",
    "levels": "1000", "svd_type": "standard", "delay_embedding": 2, "mean_center": True,
    "scale": False, "n_components": 5, "save_data_matrix": True, "mesh_shape": "space=2",
}
DEMO = {  # scripts/multiprocess_stage_demo.py's config
    "source_path": "gs://mock", "start_datetime": "2021-01-01T00",
    "end_datetime": "2021-01-02T00", "delta_time": "1h", "variables": "temperature",
    "levels": "1000", "svd_type": "standard", "svd_backend": "inmem", "delay_embedding": 2,
    "mean_center": True, "scale": False, "n_components": 8, "save_data_matrix": False,
}
GRID2D = {  # test_20's grid2d window at d = 1, on the planted slice
    "source_path": "gs://mock", "start_datetime": "2021-03-01T00",
    "end_datetime": "2021-03-02T00", "delta_time": "1h", "variables": "temperature",
    "levels": "1000", "svd_type": "randomized", "svd_backend": "grid2d",
    "delay_embedding": 1, "mean_center": True, "scale": False, "n_components": 8,
    "save_data_matrix": False,
}
AUTO_TIME = {**GRID2D, "svd_backend": "auto", "start_datetime": "2021-06-01T00",
             "end_datetime": "2021-06-02T00"}


@contextmanager
def stage_root(path):
    """Point both packages' workdir at ``path`` (read at every call)."""
    before = os.environ.get(ROOT_ENV)
    os.environ[ROOT_ENV] = str(path)
    try:
        yield
    finally:
        os.environ[ROOT_ENV] = before


def stage_slice(cfg: dict, seed: int, plant: bool = False) -> None:
    """The JAX mock slice of ``seed`` into the workdir; with ``plant`` a
    rank-10 signal on its i.i.d. noise, so that the two packages'
    different sketches find the same leading subspace."""
    parsed = config_parser(dict(cfg), "era5-svd")
    fs = create_mock_era5(parsed["start_datetime"], parsed["end_datetime"],
                          parsed["variables"], parsed["levels"], seed=seed)
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


def row_centred_panel() -> np.ndarray:
    """test_torch_qr_panel's row-centred panel (X 1 = 0)."""
    rng = np.random.default_rng(0)
    m, t = 2048, 64
    hours = np.arange(t)
    x = np.zeros((m, t))
    for damp, period, amp in ((-0.002, 24.0, 12.0), (-0.004, 12.0, 8.0), (-0.001, 84.0, 6.0)):
        c = rng.standard_normal(m) + 1j * rng.standard_normal(m)
        x += amp * np.real(np.outer(c, np.exp((damp + 2j * np.pi / period) * hours)))
    x += 0.15 * rng.standard_normal((m, t)) + 250.0
    return (x - x.mean(axis=1, keepdims=True)).astype(np.float32)


def _inputs(p: int) -> dict:
    rng = np.random.default_rng(0)
    demo = (rng.standard_normal((512, 8)) @ rng.standard_normal((8, 32))).astype(np.float32)
    rng = np.random.default_rng(p)  # dryrun_multichip's draws at this P
    return {
        "demo": demo,
        "graft_h": rng.standard_normal((64 * p, 24)).astype(np.float32),
        "graft_t": rng.standard_normal((64 * p, 24)).astype(np.float32),
        "graft_g": rng.standard_normal((64 * 2, 32)).astype(np.float32),
        "omega_g": np.asarray(jax.random.normal(jax.random.key(0), (32, 14), jnp.float32)),
        "centred": row_centred_panel(),
    }


def _cases(p: int, fail_root=None) -> list[dict]:
    def case(name, fn, **args):
        return {"name": name, "fn": fn, "args": args}

    cases = [
        case("demo_stage", "stage_case", config=json.dumps(DEMO), stage_slice="11"),
        case("graft_h", "hankel_case", op="exact", x="graft_h", d=3, k=4),
        case("graft_t", "svd_case", op="exact", x="graft_t", k=4),
    ]
    if p == 2:
        cases += [
            case("stage06", "stage_case", config=json.dumps(STAGE_06)),
            case("demo", "svd_case", op="randomized", x="demo", k=4, own_rows=True),
            case("centred", "svd_case", op="tsqr", x="centred", method="cholqr2_split"),
            case("write_fails", "stage_fails_case", config=json.dumps(STAGE_06),
                 root=str(fail_root), write_artifact=True),
            case("pack_fails", "stage_fails_case", config=json.dumps(DEMO),
                 root=str(fail_root)),
        ]
    if p == 4:
        cases += [
            case("auto", "stage_case", config=json.dumps({**AUTO_TIME,
                                                          "mesh_shape": "space=2,time=2"}),
                 resolve_only=True),
            case("graft_g", "grid_case", op="svd2d", x="graft_g", k=4,
                 shape="data=1,space=2,time=2", omega="omega_g", ingest=True),
            case("grid2d", "stage_case", config=json.dumps({**GRID2D,
                                                            "mesh_shape": "space=2,time=2"})),
        ]
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("era5_svd_mesh")
    out = {}
    for p in WORLDS:
        root = base / f"p{p}" / "root"
        fail_root = base / f"p{p}" / "fail_root"
        with stage_root(root):
            if p == 2:
                stage_slice(STAGE_06, seed=5)
            if p == 4:
                stage_slice(GRID2D, seed=7, plant=True)
        if p == 2:
            with stage_root(fail_root):
                stage_slice(STAGE_06, seed=5)
                stage_slice(DEMO, seed=11)
            (fail_root / "data" / "era5_svd").write_text("")  # where the stage's directory goes
        out[p] = (Ranks(p, _cases(p, fail_root), _inputs(p), base / f"p{p}", timeout=240,
                        extra_env={ROOT_ENV: str(root)}), root)
    return out


def _outs(worlds, p):
    return worlds[p][0].wait()


def _alike(outs, name: str, keys=("U", "s", "V")):
    for o in outs[1:]:
        for key in keys:
            np.testing.assert_array_equal(o[f"{name}/{key}"], outs[0][f"{name}/{key}"])
    return outs[0]


def _cos_min(u_a: np.ndarray, u_b: np.ndarray) -> float:
    qa, _ = np.linalg.qr(u_a.astype(np.float64))
    qb, _ = np.linalg.qr(u_b.astype(np.float64))
    return float(np.linalg.svd(qa.T @ qb, compute_uv=False).min())


def test_svd_stage_mesh_shape_from_config(worlds):
    """test_06:409 on 2 ranks: ``mesh_shape = space=2`` from the config;
    s within 1e-3 of the host SVD of the stage's own X."""
    got = _alike(_outs(worlds, 2), "stage06", keys=("U", "s", "V", "X"))
    s_host = np.linalg.svd(got["stage06/X"].astype(np.float64), compute_uv=False)[:5]
    np.testing.assert_allclose(got["stage06/s"], s_host, rtol=1e-3)


def test_auto_prefers_grid2d_on_time_mesh(worlds):
    """test_20:263: d = 1, randomized, a time-sharded stage mesh of 4
    ranks: auto resolves to grid2d, as the JAX resolver on space=2,
    time=4."""
    parsed = config_parser({**AUTO_TIME, "mesh_shape": "space=2,time=4"}, "era5-svd")
    ref = era5_svd.resolve_svd_backend(parsed, jmake_mesh(parsed["mesh_shape"]))
    for o in _outs(worlds, 4):
        assert str(o["auto/backend"]) == ref == "grid2d"


def test_grid2d_stage_route_matches_jax(worlds, tmp_path):
    """The grid2d stage route on (1, 2, 2) (ingest rows, one all_to_all
    to the grid, ``randomized_svd_2d``) against the JAX stage's grid2d on
    space=2, time=4, on the planted slice: test_20's randomized
    tolerances (s rtol 2e-3, angle < 5e-2, U^T U within 1e-3)."""
    with stage_root(tmp_path):
        stage_slice(GRID2D, seed=7, plant=True)
        ref = era5_svd.main({**GRID2D, "mesh_shape": "space=2,time=4"}, write_artifact=False)[0]
    got = _alike(_outs(worlds, 4), "grid2d")
    assert str(got["grid2d/backend"]) == ref.attrs["svd_backend"] == "grid2d"
    u = got["grid2d/U"]
    assert u.shape == ref["U"].values.shape and got["grid2d/V"].shape == ref["V"].values.shape
    np.testing.assert_allclose(got["grid2d/s"], ref["s"].values, rtol=2e-3)
    assert np.arccos(min(_cos_min(u, ref["U"].values), 1.0)) < 5e-2
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), atol=1e-3)


def test_two_process_distributed_svd(worlds):
    """test_16's ``multiprocess_demo.py`` as a gloo world of 2: each rank
    holds only its own rows; the randomized SVD's s within 1e-2 of the
    host's."""
    x = _inputs(2)["demo"]
    s_host = np.linalg.svd(x, compute_uv=False)[:4]
    for o in _outs(worlds, 2):
        np.testing.assert_allclose(o["demo/s"], s_host, rtol=1e-2)


@pytest.mark.parametrize("p", [2, 3])
def test_multi_process_era5_svd_stage(worlds, p):
    """test_16's ``multiprocess_stage_demo.py`` as a gloo world of 2 and
    3: rank 0 stages the slice, every rank runs ``era5_svd.main`` and
    takes the multi-process inmem route (the packed ``.npy`` read rows by
    rank, the meshed exact SVD); s within 1e-4 of the host oracle and the
    subspace's least principal cosine above 1 - 1e-4, on every rank."""
    outs = _outs(worlds, p)
    got = _alike(outs, "demo_stage")
    assert str(got["demo_stage/backend"]) == "inmem"
    parsed = config_parser(dict(DEMO), "era5-svd")
    with stage_root(worlds[p][1]):
        ds = load_fieldset(config_parser(dict(DEMO), "era5-svd")["era5_slice_path"])
    ds, _, _ = standardize_data(ds[parsed["variables"]], scale=False)
    x = delay_embed_np(np.asarray(flatten_era5_variables(ds).data, dtype=np.float32), 2)
    u_host, s_host, _ = np.linalg.svd(x.astype(np.float64), full_matrices=False)
    np.testing.assert_allclose(got["demo_stage/s"], s_host[:8], rtol=1e-4)
    assert _cos_min(got["demo_stage/U"], u_host[:, :8]) > 1 - 1e-4
    assert not list((worlds[p][1]).rglob("*.packed.*"))


@pytest.mark.parametrize("p", WORLDS)
def test_dryrun_multichip_exact_paths(worlds, p):
    """``dryrun_multichip``'s Hankel-exact (d = 3, k = 4) and exact-TSQR
    (k = 4) paths over space=P: against the JAX functions on P devices
    and the host oracle."""
    inputs = _inputs(p)
    jmesh = jmake_mesh(f"space={p}", devices=jax.devices()[:p])
    xs, _ = jshard_rows(inputs["graft_h"], jmesh)
    ref = jh.hankel_exact_svd(xs, d=3, n_components=4, mesh=jmesh)
    s_ref = np.linalg.svd(inputs["graft_t"].astype(np.float64), compute_uv=False)[:4]
    outs = _outs(worlds, p)
    for o in outs:
        np.testing.assert_allclose(o["graft_h/s"], np.asarray(ref.s), rtol=1e-4)
        np.testing.assert_allclose(o["graft_t/s"], s_ref, rtol=2e-3)
    ut = outs[0]["graft_t/u"]
    np.testing.assert_allclose(ut.T @ ut, np.eye(4), atol=1e-4)


def test_dryrun_multichip_grid2d_path(worlds):
    """``dryrun_multichip``'s grid2d path on (1, 2, 2): the row-sharded
    ingest resharded to the grid (here one all_to_all over time) and
    ``randomized_svd_2d``, against the JAX path on the same sketch."""
    inputs = _inputs(4)
    gmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(1, 2, 2), MESH_AXES)
    xg_rows, _ = load_row_sharded(inputs["graft_g"], gmesh, axis="space")
    xg = jax.jit(lambda a: a, out_shardings=grid_sharded(gmesh))(xg_rows)
    ref = jsvd.randomized_svd_2d(xg, 4, gmesh, seed=0)
    outs = _outs(worlds, 4)
    for o in outs:
        np.testing.assert_allclose(o["graft_g/s"], np.asarray(ref.s), rtol=1e-3)
        assert (o["graft_g/log"][:, 0] == 3).sum() == 1  # the one all_to_all
    np.testing.assert_allclose(outs[0]["graft_g/u"], np.asarray(ref.U), atol=5e-3)


def test_meshed_split_leaf_on_row_centred_panel_matches_jax_fault(worlds):
    """The split CholQR2 leaf's fault (ROADMAP Queue 3) on the meshed
    TSQR: a row-centred panel on 2 ranks, the leaf on each rank's rows
    and the tree combine; U from R's leading singular vectors is off
    orthonormal by more than 5e-4 in the port and in the JAX package, and
    by the same amount to 1e-5."""
    x = _inputs(2)["centred"]
    t = x.shape[1]

    def u_dev(q, r):
        u_r = np.linalg.svd(np.asarray(r, np.float64))[0][:, : t // 2]
        u = np.asarray(q, np.float64) @ u_r
        return np.abs(u.T @ u - np.eye(t // 2)).max()

    jmesh = jmake_mesh("space=2", devices=jax.devices()[:2])
    xs, _ = jshard_rows(x, jmesh)
    q_j, r_j = jtsqr(xs, jmesh, method="cholqr2_split")
    dev_j = u_dev(np.asarray(q_j), r_j)
    for o in _outs(worlds, 2):
        dev_t = u_dev(o["centred/q"], o["centred/r"])
        assert dev_t > 5e-4 and dev_j > 5e-4
        assert abs(dev_t - dev_j) <= 1e-5, (dev_t, dev_j)


@pytest.mark.parametrize("name", ["write_fails", "pack_fails"])
def test_rank0_write_failure_raises_on_every_rank(worlds, name):
    """Rank 0 alone writes the artifact (``write_fails``) or the inmem
    route's packed matrix (``pack_fails``); when that write fails, every
    rank of the world of 2 raises with rank 0's error instead of waiting
    on it until the group's timeout."""
    errors = [str(o[f"{name}/error"]) for o in _outs(worlds, 2)]
    blocked = str(worlds[2][1].parent / "fail_root" / "data" / "era5_svd")
    assert all(blocked in e for e in errors), errors  # rank 0's failure, on every rank
    assert "rank 0 failed" not in errors[0] and "rank 0 failed" in errors[1], errors
