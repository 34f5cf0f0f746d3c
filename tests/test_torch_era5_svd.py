"""Parity of the port's SVD-stage dispatcher and its host layers with
the JAX package.

``core`` (config reading and parsing: the same dict for every section
of config.ini, the same exceptions on invalid fields), the labels and
transforms the dispatcher packages with, ``resolve_svd_backend`` on the
cases of tests/test_20_svd_backends.py:251-400 at a one-device mesh, and
``svd_on_era5`` by its hankel (randomized and exact), inmem and streamed
backends on the flat field of the JAX mock, at test_20's tolerances.
The port runs on the CPU (``device="cpu"``), its kernels' plain versions.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from dmd_era5_tpu.core import config_parser as parse_jax
from dmd_era5_tpu.core import config_reader as read_jax
from dmd_era5_tpu.parallel.mesh import single_device_mesh
from dmd_era5_tpu.pipeline import era5_svd as svd_jax
from dmd_era5_tpu.snapmat import create_mock_era5
from dmd_era5_tpu.snapmat import flatten_era5_variables as flatten_jax
from dmd_era5_tpu.snapmat import standardize_data as standardize_jax
from dmd_era5_tpu.snapmat.transform import apply_delay_embedding as embed_jax
from dmd_era5_tpu_torch.core import config_parser as parse_torch
from dmd_era5_tpu_torch.core import config_reader as read_torch
from dmd_era5_tpu_torch.core.logging import _process_tag
from dmd_era5_tpu_torch.pipeline import era5_svd as svd_torch
from dmd_era5_tpu_torch.snapmat import transform as transform_torch
from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

CONFIG = Path(__file__).resolve().parents[1] / "config.ini"
SECTIONS = ("era5-download", "era5-svd", "era5-dmd")


@pytest.mark.parametrize("section", SECTIONS)
def test_config_sections_parse_alike(section):
    raw = read_torch(section, CONFIG)
    assert raw == read_jax(section, CONFIG)
    assert parse_torch(dict(raw), section) == parse_jax(dict(raw), section)


def _bad(section: str, **fields):
    return pytest.param(section, fields, id=f"{section}-" + "-".join(f"{k}={v}" for k, v in fields.items()))


INVALID = [
    _bad("era5-svd", svd_type="magic"), _bad("era5-svd", delay_embedding=0),
    _bad("era5-svd", delay_embedding=True), _bad("era5-svd", mean_center="yes"),
    _bad("era5-svd", n_components=0), _bad("era5-svd", forecast_holdout=-1),
    _bad("era5-svd", svd_backend="magic"), _bad("era5-svd", svd_backend="grid2d", svd_type="standard"),
    _bad("era5-svd", precision="float16"), _bad("era5-download", delta_time="3x"),
    _bad("era5-download", delta_time="h"), _bad("era5-download", variables="2m_temperature"),
    _bad("era5-download", variables="all_single_level_vars"), _bad("era5-download", variables="foo"),
    _bad("era5-download", levels="999"), _bad("era5-download", levels="abc"),
    _bad("era5-download", start_datetime="not a date"),
    _bad("era5-download", end_datetime="2018-12-31T00"),
    _bad("era5-download", start_datetime="2999-01-01T00", end_datetime="2999-01-02T00"),
    _bad("era5-dmd", dmd_rank=11), _bad("era5-dmd", optimized="yes"),
    _bad("era5-dmd", bagging_trials=2, optimized=False), _bad("era5-dmd", bagging_fraction=1.5),
    _bad("era5-dmd", control_input="foo"), _bad("era5-dmd", dmdc_rank_omega=0),
    _bad("era5-dmd", mr_max_cycles=0), _bad("era5-dmd", forecast_steps=-1),
    _bad("era5-dmd", lm_max_iter=0), _bad("era5-dmd", multiresolution_levels=-1),
    _bad("era5-dmd", mr_refit_rank=-1), _bad("era5-svd", source_path=None),
]


@pytest.mark.parametrize("section,fields", INVALID)
def test_config_invalid_fields_raise_alike(section, fields):
    cfg = {**read_torch(section, CONFIG), **fields}
    if fields.get("source_path", "") is None:
        del cfg["source_path"]  # a missing required field
    with pytest.raises(Exception) as err_j:
        parse_jax(dict(cfg), section)
    with pytest.raises(Exception) as err_t:
        parse_torch(dict(cfg), section)
    assert type(err_t.value) is type(err_j.value)
    assert str(err_t.value) == str(err_j.value)


def test_unknown_section_and_missing_file_section_raise_alike():
    for fn in (parse_jax, parse_torch):
        with pytest.raises(ValueError, match="not currently supported"):
            fn({}, "era5-nope")
    for fn in (read_jax, read_torch):
        with pytest.raises(Exception, match="Section era5-nope not found"):
            fn("era5-nope", CONFIG)


def test_process_tag_without_a_group():
    assert _process_tag() == ""


# -------------------------------------------------------- backend routing

BASE = {
    "source_path": "gs://mock", "delta_time": "1h", "variables": "temperature",
    "levels": "1000", "svd_type": "randomized", "delay_embedding": 2,
    "mean_center": True, "scale": False, "n_components": 8, "save_data_matrix": False,
    "start_datetime": "2021-06-01T00", "end_datetime": "2021-06-02T00",
}
WEEK_ROWS, WEEK_COLS = 721 * 1440 * 15, 168

ROUTES = [  # (overrides, have_flat, matrix rows/cols or None, budget env, expected)
    (dict(), True, None, None, "hankel"),
    (dict(), False, None, None, "inmem"),
    (dict(delay_embedding=1), True, None, None, "inmem"),
    (dict(svd_type="standard"), True, None, None, "hankel"),
    (dict(svd_backend="grid2d"), True, None, None, "hankel"),
    (dict(svd_backend="grid2d"), False, None, None, "grid2d"),
    (dict(svd_backend="grid2d", delay_embedding=1), True, None, None, "grid2d"),
    (dict(svd_type="standard", delay_embedding=1), True, None, None, "inmem"),
    (dict(svd_backend="hankel", svd_type="standard"), True, None, None, "hankel"),
    (dict(delay_embedding=1), True, (WEEK_ROWS, WEEK_COLS), None, "streamed"),
    (dict(delay_embedding=1), True, (1 << 19, 512), None, "inmem"),
    (dict(delay_embedding=1), True, (1 << 19, 512), "0.001", "streamed"),
    (dict(delay_embedding=1, svd_type="standard"), True, (WEEK_ROWS, WEEK_COLS), "12", "streamed"),
    (dict(delay_embedding=1, svd_type="standard"), True, (1 << 19, WEEK_COLS), "12", "inmem"),
]


@pytest.mark.parametrize("overrides,have_flat,shape,budget,expected", ROUTES)
def test_resolve_svd_backend_matches_one_device_mesh(
    monkeypatch, overrides, have_flat, shape, budget, expected
):
    if budget is not None:
        monkeypatch.setenv(svd_torch.HBM_BUDGET_ENV, budget)
    cfg = {**BASE, "svd_backend": "auto", **overrides}
    parsed = parse_torch(dict(cfg), "era5-svd")
    if shape is not None:
        parsed["_matrix_rows"], parsed["_matrix_cols"] = shape
    got = svd_torch.resolve_svd_backend(dict(parsed), have_flat=have_flat)
    ref = svd_jax.resolve_svd_backend(dict(parsed), single_device_mesh(), have_flat=have_flat)
    assert got == ref == expected


@pytest.mark.parametrize("overrides,expected", [
    (dict(mesh_shape="space=2,time=4"), ValueError),
    (dict(mesh_shape="time=8"), ValueError),
    (dict(dcn_mesh_shape="data=2"), ValueError),
    (dict(svd_backend="grid2d", delay_embedding=1), "jax"),
])
def test_svd_on_era5_refuses_what_needs_a_mesh(mock_flat, overrides, expected):
    """What needs more ranks than the world has: a ``mesh_shape`` or a
    ``dcn_mesh_shape`` that one process cannot cover raises ``ValueError``
    (as ``parallel.make_mesh`` does; the JAX package's "incompatible with
    N devices").  The ``grid2d`` backend on the one-rank mesh runs, and
    matches the JAX package's on ``single_device_mesh()`` at test_20's
    randomized tolerances (the packages draw different sketches)."""
    cfg = {**BASE, **overrides}
    if expected is ValueError:
        parsed = parse_torch(cfg, "era5-svd")
        field = Field(np.zeros((16, 12), np.float32), ("space", "time"))
        with pytest.raises(ValueError, match="devices"):
            svd_torch.svd_on_era5(None, parsed, device="cpu", da_flat=field)
        return
    flat_j, flat_t = mock_flat
    cfg.update(start_datetime="2021-01-01T00", end_datetime="2021-01-02T00")
    parsed_j, parsed_t = parse_jax(dict(cfg), "era5-svd"), parse_torch(dict(cfg), "era5-svd")
    u_j, s_j, _ = svd_jax.svd_on_era5(None, parsed_j, mesh=single_device_mesh(), da_flat=flat_j)
    u, s, v = svd_torch.svd_on_era5(None, parsed_t, device="cpu", da_flat=flat_t)
    assert parsed_t["metrics"]["svd_backend"] == parsed_j["metrics"]["svd_backend"] == "grid2d"
    k = BASE["n_components"]
    assert u.shape == np.shape(u_j) and v.shape == (k, flat_t.shape[1])
    np.testing.assert_allclose(s, np.asarray(s_j), rtol=2e-3)
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=1e-3)
    qa, _ = np.linalg.qr(u.astype(np.float64))
    qb, _ = np.linalg.qr(np.asarray(u_j, dtype=np.float64))
    assert np.linalg.svd(qa.T @ qb, compute_uv=False).min() > np.cos(5e-2)


# ------------------------------------------------------- the dispatcher

def _port_field(f) -> Field:
    """A JAX-package Field as the port's (numpy data, same coords)."""
    coords = {k: Coord(c.dims, c.values) for k, c in f.coords.items()}
    return Field(np.array(f.data), f.dims, coords, dict(f.attrs), f.name)


@pytest.fixture(scope="module")
def mock_flat():
    """The standardized mock slice of test_20 (5-degree grid, one day),
    flattened by both packages, with a rank-10 signal planted on the
    mock's i.i.d. noise: the two packages draw different Gaussian
    sketches, which agree only where the spectrum separates the leading
    k from the rest.  Returns (JAX field, port field)."""
    fs = create_mock_era5("2021-01-01T00", "2021-01-02T00", ["temperature"], [1000], seed=7)
    fs, _, _ = standardize_jax(fs, scale=False)
    flat_j = flatten_jax(fs)
    port_fs = FieldSet({k: _port_field(v) for k, v in fs.data_vars.items()}, dict(fs.attrs))
    flat_t = transform_torch.flatten_era5_variables(port_fs)
    np.testing.assert_array_equal(flat_t.data, np.asarray(flat_j.data))
    rng = np.random.default_rng(11)
    n_space, n_time = flat_t.shape
    u0, _ = np.linalg.qr(rng.standard_normal((n_space, 10)))
    v0, _ = np.linalg.qr(rng.standard_normal((n_time, 10)))
    data = (flat_t.data + (u0 * np.geomspace(8000.0, 3000.0, 10)) @ v0.T).astype(np.float32)
    return flat_j.copy(data=data), flat_t.copy(data=data.copy())


def test_flatten_and_embedding_match():
    fs = create_mock_era5("2021-01-01T00", "2021-01-01T05", ["temperature", "u_component_of_wind"],
                          [1000, 500], seed=3)
    flat_j = flatten_jax(fs)
    port_fs = FieldSet({k: _port_field(v) for k, v in fs.data_vars.items()}, dict(fs.attrs))
    flat_t = transform_torch.flatten_era5_variables(port_fs)
    np.testing.assert_array_equal(flat_t.data, np.asarray(flat_j.data))
    assert flat_t.dims == flat_j.dims and flat_t.attrs == flat_j.attrs
    for name, coord in flat_j.coords.items():
        np.testing.assert_array_equal(flat_t.coords[name].values, coord.values)
    emb_j, emb_t = embed_jax(flat_j, 3), transform_torch.apply_delay_embedding(flat_t, 3)
    np.testing.assert_array_equal(emb_t.data, np.asarray(emb_j.data))
    assert emb_t.coords.keys() == emb_j.coords.keys()
    for name in emb_j.coords:
        np.testing.assert_array_equal(emb_t.coords[name].values, emb_j.coords[name].values)


def _field_on(flat: Field, device: str) -> Field:
    return Field(torch.from_numpy(np.array(flat.data, dtype=np.float32)).to(device), flat.dims,
                 flat.coords, flat.attrs, flat.name)


@pytest.mark.parametrize("svd_type,backend,d", [
    ("randomized", "hankel", 2), ("standard", "hankel", 2),
    ("randomized", "inmem", 2), ("standard", "inmem", 2),
    ("randomized", "streamed", 1), ("standard", "streamed", 2),
])
def test_svd_on_era5_matches_jax(mock_flat, svd_type, backend, d):
    """test_20's tolerances: s to rtol 2e-3 (randomized: the two packages
    draw different sketches) or 1e-4 (exact); U^T U to atol 1e-3 / 1e-4;
    U's columns span the same subspace."""
    flat_j, flat_t = mock_flat
    cfg = {**BASE, "start_datetime": "2021-01-01T00", "end_datetime": "2021-01-02T00",
           "svd_type": svd_type, "svd_backend": backend, "delay_embedding": d}
    parsed_j, parsed_t = parse_jax(dict(cfg), "era5-svd"), parse_torch(dict(cfg), "era5-svd")
    u_j, s_j, v_j = svd_jax.svd_on_era5(None, parsed_j, mesh=single_device_mesh(), da_flat=flat_j)
    field = flat_t if backend != "hankel" else _field_on(flat_t, "cpu")
    u, s, v = svd_torch.svd_on_era5(None, parsed_t, device="cpu", da_flat=field)
    assert all(isinstance(a, np.ndarray) for a in (u, s, v))
    k = BASE["n_components"]
    assert u.shape == np.shape(u_j) == (flat_t.shape[0] * d, k)
    assert v.shape == np.shape(v_j) == (k, flat_t.shape[1] - d + 1)
    assert parsed_t["metrics"]["svd_backend"] == parsed_j["metrics"]["svd_backend"] == backend
    assert parsed_t["metrics"]["svd_seconds"] > 0
    exact = svd_type == "standard"
    np.testing.assert_allclose(s, np.asarray(s_j), rtol=1e-4 if exact else 2e-3)
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=1e-4 if exact else 1e-3)
    qa, _ = np.linalg.qr(u.astype(np.float64))
    qb, _ = np.linalg.qr(np.asarray(u_j, dtype=np.float64))
    angle = np.arccos(np.clip(np.linalg.svd(qa.T @ qb, compute_uv=False).min(), -1, 1))
    assert angle < (5e-3 if exact else 5e-2), angle
    assert not list(Path(parsed_t["save_path"]).parent.glob("*.packed.*"))


def test_svd_on_era5_keeps_a_device_tensor_where_it_lies(mock_flat, monkeypatch):
    """A Field holding a tensor is handed to the SVD as it is (no host
    copy), and the device follows the tensor when none is given."""
    _, flat_t = mock_flat
    field = _field_on(flat_t, "cpu")
    seen = []
    real = svd_torch.hankel_randomized_svd_fused

    def spy(x, *args, **kwargs):
        seen.append(x)
        return real(x, *args, **kwargs)

    monkeypatch.setattr(svd_torch, "hankel_randomized_svd_fused", spy)
    parsed = parse_torch({**BASE, "start_datetime": "2021-01-01T00",
                          "end_datetime": "2021-01-02T00"}, "era5-svd")
    svd_torch.svd_on_era5(None, parsed, da_flat=field)
    assert seen[0] is field.data


def test_svd_on_era5_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parsed = parse_torch(dict(BASE), "era5-svd")
    field = Field(np.zeros((16, 12), np.float32), ("space", "time"))
    with pytest.raises(RuntimeError, match="CUDA card"):
        svd_torch.svd_on_era5(None, parsed, da_flat=field)


def test_combine_svd_results_matches(mock_flat):
    flat_j, flat_t = mock_flat
    rng = np.random.default_rng(3)
    d, k = 2, 4
    u = rng.standard_normal((flat_t.shape[0] * d, k)).astype(np.float32)
    s = np.arange(k, 0, -1).astype(np.float32)
    v = rng.standard_normal((k, flat_t.shape[1] - d + 1)).astype(np.float32)
    coords_t = transform_torch.delay_embedded_coords(flat_t, d)
    coords_j = svd_jax.delay_embedded_coords(flat_j, d)
    out_t = svd_torch.combine_svd_results(u, s, v, coords_t, X_mean=None)
    out_j = svd_jax.combine_svd_results(u, s, v, coords_j, X_mean=None)
    assert out_t.variables == out_j.variables == ["U", "s", "V"]
    for name in out_j.variables:
        a, b = out_t[name], out_j[name]
        assert a.dims == b.dims and a.name == b.name
        np.testing.assert_array_equal(a.values, b.values)
        for cname, coord in b.coords.items():
            np.testing.assert_array_equal(a.coords[cname].values, coord.values)


def test_parsed_config_is_not_shared(mock_flat):
    """The dispatcher writes its metrics into the dict it is given only."""
    _, flat_t = mock_flat
    parsed = parse_torch({**BASE, "start_datetime": "2021-01-01T00",
                          "end_datetime": "2021-01-02T00", "svd_type": "standard"}, "era5-svd")
    before = copy.deepcopy(parsed)
    svd_torch.svd_on_era5(None, parsed, device="cpu", da_flat=flat_t)
    assert set(parsed) - set(before) == {"_matrix_rows", "_matrix_cols", "metrics"}
