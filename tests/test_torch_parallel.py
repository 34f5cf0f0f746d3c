"""Parity of the port's distributed layer with the JAX package's.

tests/test_04_parallel.py case by case: mesh shapes and grids (the port's
rank grid equals the JAX device grid's ids, the hybrid mesh's DCN-major
interleave included), every collective against its JAX counterpart inside
``shard_map`` on the conftest's 8 virtual CPU devices (the port's on 8
gloo ranks, ``torch_mesh_ranks``), layouts and ``reshard``,
``initialize_distributed`` in one process and from the environment in
two, and tests/test_09_loader_native.py's ``load_row_sharded`` (:88-101)
over 4 ranks from ``.npy`` and HDF5, f32 and bf16.  The mesh needs a
card unless the CPU is asked for.
"""

from __future__ import annotations

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_mesh_ranks import Ranks

from dmd_era5_tpu.parallel import collectives as jc
from dmd_era5_tpu.parallel import make_hybrid_mesh as jmake_hybrid_mesh
from dmd_era5_tpu.parallel import make_mesh as jmake_mesh
from dmd_era5_tpu.parallel import mesh_from_config as jmesh_from_config
from dmd_era5_tpu.parallel import shard_rows as jshard_rows
from dmd_era5_tpu.snapmat import create_mock_era5 as jcreate_mock_era5
from dmd_era5_tpu.snapmat import loader as jloader
from dmd_era5_tpu_torch import parallel as tpar
from dmd_era5_tpu_torch.parallel import mesh as tmesh


def _ids(mesh) -> np.ndarray:
    return np.vectorize(lambda dev: dev.id)(mesh.devices)


def _inputs() -> dict:
    rng = np.random.default_rng(11)
    return {
        "blocks": rng.standard_normal((2, 4, 3, 5)).astype(np.float32),
        "row": np.arange(12, dtype=np.float32).reshape(1, 12),
        "a2a": np.arange(16 * 24, dtype=np.float32).reshape(16, 24),
        "odd": rng.standard_normal((1003, 4)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def collective_ranks(tmp_path_factory):
    return Ranks(8, [{"name": "c", "fn": "collectives_case"}], _inputs(),
                 tmp_path_factory.mktemp("collectives"))


# ----------------------------------------------------------------- mesh


def test_parse_mesh_shape():
    assert tpar.parse_mesh_shape(None) is None
    assert tpar.parse_mesh_shape("auto") is None
    assert tpar.parse_mesh_shape("space=4,time=2") == {"space": 4, "time": 2}
    with pytest.raises(ValueError, match="Unknown mesh axis"):
        tpar.parse_mesh_shape("bogus=2")
    with pytest.raises(ValueError, match=">= 1"):
        tpar.parse_mesh_shape("space=0")


@pytest.mark.parametrize("shape", [None, "space=4,time=2", "data=2,space=4", "time=8",
                                   "data=2,space=2,time=2", {"data": 2}, "time=2"])
def test_make_mesh_rank_grid_is_the_jax_device_grid(shape):
    port = tpar.make_mesh(shape, ranks=range(8), device="cpu")
    jax_mesh = jmake_mesh(shape)
    assert port.shape == dict(jax_mesh.shape)
    np.testing.assert_array_equal(port.ranks, _ids(jax_mesh))


def test_make_mesh_bad_shape():
    with pytest.raises(ValueError, match="incompatible|does not cover"):
        tpar.make_mesh("space=3", ranks=range(8), device="cpu")
    with pytest.raises(ValueError, match="incompatible|does not cover"):
        tpar.make_mesh("space=2,data=2,time=1", ranks=range(8), device="cpu")


@pytest.mark.parametrize("ici, dcn", [(None, "data=2"), ("space=2,data=2", "space=2"),
                                      ("time=2", "data=2"), (None, None)])
def test_hybrid_mesh_rank_grid_is_the_jax_device_grid(ici, dcn):
    """test_04's TestHybridMesh layouts: DCN-major per axis, each space
    line inside one slice where DCN does not split space."""
    port = tpar.make_hybrid_mesh(ici, dcn, ranks=range(8), n_slices=2, device="cpu")
    jax_mesh = jmake_hybrid_mesh(ici, dcn, n_slices=2)
    assert port.shape == dict(jax_mesh.shape)
    np.testing.assert_array_equal(port.ranks, _ids(jax_mesh))


def test_hybrid_mesh_uneven_slices_raise():
    with pytest.raises(ValueError, match="not divisible"):
        tpar.make_hybrid_mesh(dcn_shape="data=3", ranks=range(8), n_slices=3, device="cpu")


@pytest.mark.parametrize("config", [{"mesh_shape": "data=2,space=4"},
                                    {"mesh_shape": "auto"},
                                    {"mesh_shape": None, "dcn_mesh_shape": "data=2"}])
def test_mesh_from_config(config, monkeypatch):
    """mesh_from_config routes a dcn shape to the hybrid mesh; a host's
    ranks (LOCAL_WORLD_SIZE) are the port's slice, as a TPU slice's
    devices are the JAX package's."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(tmesh, "_world_ranks", lambda ranks: list(range(8)))
    port = tpar.mesh_from_config(config, device="cpu")
    if config.get("dcn_mesh_shape"):
        jax_mesh = jmake_hybrid_mesh(config["mesh_shape"], config["dcn_mesh_shape"],
                                     n_slices=2)
    else:
        jax_mesh = jmesh_from_config(config)
    np.testing.assert_array_equal(port.ranks, _ids(jax_mesh))


def test_single_device_mesh_collectives_are_the_identity():
    from dmd_era5_tpu_torch.parallel import collectives as c

    mesh = tpar.single_device_mesh("cpu")
    assert mesh.shape == {"data": 1, "space": 1, "time": 1} and mesh.ranks.size == 1
    x = torch.arange(6.0).reshape(2, 3)
    with c.collective_log() as log:
        assert torch.equal(c.psum(x, "space", mesh), x)
        assert torch.equal(c.all_gather(x, "time", mesh), x[None])
        assert torch.equal(c.ring_permute(x, "space", mesh), x)
    assert log.calls == []


def test_all_gather_packed_keeps_each_tensor_its_dtype_and_shape():
    from dmd_era5_tpu_torch.parallel import collectives as c

    mesh = tpar.single_device_mesh("cpu")
    gen = torch.Generator().manual_seed(0)
    tensors = [torch.randn((3, 2), dtype=torch.complex64, generator=gen),
               torch.randn((3, 2, 4), dtype=torch.complex64, generator=gen),
               torch.tensor([1.5, float("nan"), float("inf")]),
               torch.tensor([7, 0, 50], dtype=torch.int32),
               torch.randn((3, 5), dtype=torch.float64, generator=gen)]
    out = c.all_gather_packed(tensors, "data", mesh)
    for got, want in zip(out, tensors, strict=True):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        assert torch.equal(got.isnan(), want.isnan())


def test_layout_without_a_group_refuses_collectives():
    from dmd_era5_tpu_torch.parallel import collectives as c

    mesh = tpar.make_mesh("space=8", ranks=range(8), device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        c.psum(torch.ones(2), "space", mesh)


# ---------------------------------------------------------- collectives


def _jax_per_device(mesh, body, x, in_spec, out_rank: int = 2):
    """Run ``body`` per device; returns the (data, space) grid of outputs,
    each device's result carried on two leading unit axes."""
    return np.asarray(jax.shard_map(
        lambda b: body(b)[(None,) * out_rank], mesh=mesh, in_specs=in_spec,
        out_specs=P("data", "space"), check_vma=False)(x))


def test_psum_pmean_all_gather_and_axis_index_match_shard_map(collective_ranks):
    mesh = jmake_mesh("data=2,space=4")
    blocks = _inputs()["blocks"]
    spec = P("data", "space")
    refs = {
        "psum": _jax_per_device(mesh, lambda b: jc.psum(b[0, 0], "space"), blocks, spec),
        "pmean": _jax_per_device(mesh, lambda b: jc.pmean(b[0, 0], "space"), blocks, spec),
        "psum_data": _jax_per_device(mesh, lambda b: jc.psum(b[0, 0], "data"), blocks, spec),
        "all_gather": _jax_per_device(mesh, lambda b: jc.all_gather(b[0, 0], "space"),
                                      blocks, spec),
        "all_gather_tiled": _jax_per_device(
            mesh, lambda b: jc.all_gather(b[0, 0], "space", axis=1, tiled=True), blocks, spec),
        "axis": _jax_per_device(mesh, lambda b: jnp.stack(
            [jc.axis_index("data"), jc.axis_index("space"),
             jnp.int32(jc.axis_size("data")), jnp.int32(jc.axis_size("space"))]), blocks, spec),
    }
    ids = _ids(mesh)
    for o in collective_ranks.wait():
        d, s = np.argwhere(ids == int(o["c/rank"]))[0][:2]
        for key, ref in refs.items():
            np.testing.assert_allclose(o[f"c/{key}"], ref[d, s], rtol=1e-6, atol=1e-6,
                                       err_msg=key)  # summation order


def test_ring_permute_and_halo_exchanges_match_shard_map(collective_ranks):
    """test_04's ring and halo cases on (space 2, time 4): block i gets
    block i - 1's values; halos prepend the left neighbour's last two
    columns (zeros at the first block) or append the right one's first
    two (zeros at the last)."""
    mesh = jmake_mesh("time=4")
    row = jnp.asarray(_inputs()["row"])

    def run(body, width):
        out = jax.shard_map(body, mesh=mesh, in_specs=P(None, "time"),
                            out_specs=P(None, "time"), check_vma=False)(row)
        return np.asarray(out).reshape(1, 4, width)[0]

    refs = {
        "ring": run(lambda x: jc.ring_permute(x, "time", 1), 3),
        "ring_back": run(lambda x: jc.ring_permute(x, "time", -1), 3),
        "halo_left": run(lambda x: jc.halo_exchange_left(x, "time", 2, axis=1), 5),
        "halo_right": run(lambda x: jc.halo_exchange_right(x, "time", 2, axis=1), 5),
    }
    np.testing.assert_array_equal(refs["halo_left"][0], [0, 0, 0, 1, 2])
    ids = _ids(mesh)
    for o in collective_ranks.wait():
        t = np.argwhere(ids == int(o["c/rank"]))[0][2]
        for key, ref in refs.items():
            np.testing.assert_array_equal(o[f"c/{key}"][0], ref[t], err_msg=key)


def test_all_to_all_reshard_and_shard_rows_match_jax(collective_ranks):
    """Row-sharded -> column-sharded over space by one all_to_all (test_04's
    Ulysses case and its ``reshard``), and ``shard_rows`` zero-padding
    1003 rows over 8 ranks as JAX ``shard_rows`` lays them out."""
    from dmd_era5_tpu.parallel import col_sharded, reshard, row_sharded

    mesh = jmake_mesh("space=8")
    inputs = _inputs()
    x = jnp.asarray(inputs["a2a"])
    ref = np.asarray(jax.shard_map(
        lambda b: jc.all_to_all(b, "space", split_axis=1, concat_axis=0), mesh=mesh,
        in_specs=P("space", None), out_specs=P(None, "space"))(x))
    moved = np.asarray(reshard(jax.device_put(x, row_sharded(mesh)),
                               col_sharded(mesh, axis="space")))
    padded, rows = jshard_rows(inputs["odd"], mesh)
    padded = np.asarray(padded)
    assert rows == 1003 and padded.shape[0] == 1008
    for o in collective_ranks.wait():
        s = int(o["c/rank"])
        np.testing.assert_array_equal(o["c/all_to_all"], ref[:, 3 * s:3 * s + 3])
        np.testing.assert_array_equal(o["c/reshard"], moved[:, 3 * s:3 * s + 3])
        np.testing.assert_array_equal(o["c/shard_rows"], padded[126 * s:126 * (s + 1)])


def test_collective_log_counts_every_call(collective_ranks):
    """The log has one entry a collective call, with its result's size: the
    payloads test_21 reads from HLO.  The halo exchanges are ring permutes;
    ``reshard`` is one all_to_all."""
    ops = ["psum", "all_gather", "ppermute", "all_to_all"]
    for o in collective_ranks.wait():
        log = o["c/log"]
        names = [ops[i] for i in log[:, 0]]
        assert names == ["psum"] * 3 + ["all_gather"] * 2 + ["ppermute"] * 4 + ["all_to_all"] * 2
        assert log[0, 2] == 15 and log[0, 3] == 60  # a (3, 5) f32 psum
        assert log[3, 2] == 4 * 15  # the gathered (4, 3, 5)


# -------------------------------------------------------- distributed init


def test_initialize_distributed_is_a_no_op_in_one_process(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", *tmesh._CLUSTER_ENV_MARKERS):
        monkeypatch.delenv(var, raising=False)
    assert tpar.initialize_distributed() is None
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_needs_a_rendezvous_under_slurm(monkeypatch):
    """A SLURM marker without MASTER_ADDR / MASTER_PORT raises: nothing
    falls back to a single process."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_JOB_ID", "12345")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        tpar.initialize_distributed(device="cpu")


_LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE",
                "LOCAL_RANK", "SLURM_JOB_ID", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_NODEID",
                "SLURM_LOCALID", "SLURM_TASKS_PER_NODE", "OMPI_COMM_WORLD_SIZE",
                "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK")


@pytest.mark.parametrize("launch", [
    {"SLURM_JOB_ID": "12345", "SLURM_NTASKS": "8", "SLURM_PROCID": "6", "SLURM_NODEID": "1",
     "SLURM_LOCALID": "2", "SLURM_TASKS_PER_NODE": "4(x2)"},
    {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "6",
     "OMPI_COMM_WORLD_LOCAL_SIZE": "4", "OMPI_COMM_WORLD_LOCAL_RANK": "2"},
], ids=["slurm", "openmpi"])
def test_two_host_launch_takes_nccl_the_local_card_and_two_slices(launch, monkeypatch):
    """Rank 6 of a 2-host x 4-card SLURM or OpenMPI launch (host 1's third
    rank), without torchrun's variables: NCCL, card 2 made current and
    taken by the mesh, and a hybrid mesh of one slice a host."""
    for var in _LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in {**launch, "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards, groups = [], []
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda backend, **kw: groups.append(dict(kw, backend=backend)))
    assert tpar.initialize_distributed() == "nccl"
    assert cards == [2]
    assert [(g["backend"], g["init_method"], g["world_size"], g["rank"]) for g in groups] == [
        ("nccl", "env://", 8, 6)]
    assert tmesh._mesh_device(None) == torch.device("cuda", 2)
    mesh = tpar.make_hybrid_mesh(ranks=range(8), device="cpu")
    assert mesh.shape == {"data": 2, "space": 4, "time": 1}


def test_mesh_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tpar.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA card"):
        tpar.single_device_mesh()
    with pytest.raises(RuntimeError, match="CUDA card"):
        tpar.initialize_distributed("file:///nonexistent", world_size=2, rank=0)
    assert tpar.make_mesh(device="cpu").device == torch.device("cpu")


def test_initialize_distributed_from_the_launcher_environment(tmp_path):
    """Two processes given torchrun's variables alone (no init_method)
    join one group over gloo (their rendezvous on a free localhost
    port)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = lambda r: {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),  # noqa: E731
                     "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
                     "LOCAL_WORLD_SIZE": "2"}
    outs = Ranks(2, [{"name": "e", "fn": "env_case"}], {"unused": np.zeros(1)}, tmp_path,
                 env_of_rank=env).wait()
    assert [int(o["e/rank"]) for o in outs] == [0, 1]
    assert {int(o["e/world"]) for o in outs} == {2}
    assert {str(o["e/backend"]) for o in outs} == {"gloo"}


# ------------------------------------------------------- load_row_sharded


def _packed_files(directory) -> dict:
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1003, 24)).astype(np.float32)
    fs = jcreate_mock_era5("2020-01-01", "2020-01-01T23", ["temperature"], [1000], seed=2)
    _, meta = jloader.build_snapshot_matrix(fs)
    files = {"h5": directory / "p.h5", "npy": directory / "p.npy",
             "bf16_h5": directory / "b.h5", "bf16_npy": directory / "b.npy"}
    jloader.save_packed_snapshot(files["h5"], x, meta)
    np.save(files["npy"], x)
    jloader.save_packed_matrix(files["bf16_h5"], x, bf16=True)
    np.save(files["bf16_npy"], jloader.read_packed_rows(files["bf16_h5"], 0, 1003))
    return files


def test_load_row_sharded_matches_jax(tmp_path):
    files = _packed_files(tmp_path)
    cases = [{"name": key, "fn": "loader_case", "args": {"path": str(path)}}
             for key, path in files.items()]
    ranks = Ranks(4, cases, {"unused": np.zeros(1)}, tmp_path / "ranks")
    mesh = jmake_mesh(devices=jax.devices()[:4])
    refs = {}
    for key, path in files.items():
        arr, rows = jloader.load_row_sharded(path if "npy" not in key else
                                             np.load(path), mesh)
        assert rows == 1003
        refs[key] = np.asarray(arr.astype(jnp.float32))
    outs = ranks.wait()
    for key in files:
        for o in outs:
            i = int(o[f"{key}/index"])
            assert int(o[f"{key}/rows"]) == 1003
            assert str(o[f"{key}/dtype"]) == ("torch.bfloat16" if "bf16" in key else
                                              "torch.float32")
            np.testing.assert_array_equal(o[f"{key}/block"], refs[key][251 * i:251 * (i + 1)])
        got = np.concatenate([o[f"{key}/block"] for o in sorted(
            outs, key=lambda o: int(o[f"{key}/index"]))])
        np.testing.assert_array_equal(got[1003:], 0.0)
