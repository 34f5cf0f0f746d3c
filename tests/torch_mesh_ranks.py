"""Rank processes for the port's mesh tests on the CPU.

:class:`Ranks` starts one Python process per rank (this file run as a script:
``python tests/torch_mesh_ranks.py <job.json> <rank>``).  The ranks join
one gloo group through a ``file://`` store in the test's directory (no
TCP port, so parallel test workers never meet), read the job's numpy
inputs, run its cases in order (each a function of this module named by
the case) and write their numpy outputs, one ``.npz`` a rank, which
:meth:`Ranks.wait` returns.  The ranks import torch and the port, never JAX; the
test process compares their outputs with the JAX package's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


class Ranks:
    """``world`` rank processes running ``cases`` ({"name", "fn", "args"});
    :meth:`wait` returns each rank's outputs ({"<name>/<key>": array}).
    ``env_of_rank``: a function of the rank giving launcher variables;
    the ranks then start their group from the environment alone.
    ``extra_env``: variables for every rank (such as the stage's root)."""

    def __init__(self, world: int, cases: list[dict], inputs: dict, directory: Path,
                 timeout: float = 120.0, env_of_rank=None, extra_env: dict | None = None):
        directory.mkdir(parents=True, exist_ok=True)
        np.savez(directory / "inputs.npz", **inputs)
        init = "env" if env_of_rank else f"file://{directory / 'store'}"
        self.job = {"world": world, "cases": cases, "init": init,
                    "inputs": str(directory / "inputs.npz"),
                    "out": str(directory / "rank{rank}.npz")}
        (directory / "job.json").write_text(json.dumps(self.job))
        env = {key: value for key, value in os.environ.items()
               if key not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                              "LOCAL_WORLD_SIZE", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")}
        env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **(extra_env or {}))
        self.logs = [open(directory / f"rank{r}.log", "w+") for r in range(world)]
        self.procs = [
            subprocess.Popen([sys.executable, __file__, str(directory / "job.json"), str(r)],
                             cwd=ROOT, env={**env, **(env_of_rank(r) if env_of_rank else {})},
                             stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        self.deadline = time.monotonic() + timeout
        self._results = None

    def wait(self) -> list[dict]:
        if self._results is not None:
            return self._results
        try:
            for proc in self.procs:
                proc.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        text = []
        for r, f in enumerate(self.logs):
            f.seek(0)
            text.append(f"--- rank {r} (exit {self.procs[r].returncode})\n{f.read()[-3000:]}")
            f.close()
        failed = [r for r, proc in enumerate(self.procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(text))
        self._results = [dict(np.load(self.job["out"].format(rank=r)))
                         for r in range(len(self.procs))]
        return self._results


# ------------------------------------------------------------ rank side


def _log_arrays(log) -> dict:
    """A collective log as arrays: one row a call (op code, axis code,
    elements, bytes), with the codes' names."""
    from dmd_era5_tpu_torch.parallel import MESH_AXES

    ops = ["psum", "all_gather", "ppermute", "all_to_all"]
    rows = [(ops.index(c.op), MESH_AXES.index(c.axis), c.elements, c.bytes) for c in log.calls]
    return {"log": np.asarray(rows, dtype=np.int64).reshape(-1, 4)}


def tsqr_case(inputs, x: str, method: str | None = None) -> dict:
    import torch

    from dmd_era5_tpu_torch.ops.tsqr import tsqr
    from dmd_era5_tpu_torch.parallel import make_mesh, shard_rows
    from dmd_era5_tpu_torch.parallel.collectives import collective_log

    mesh = make_mesh(device="cpu")
    x_loc, _ = shard_rows(inputs[x], mesh)
    with collective_log() as log:
        q, r = tsqr(x_loc, mesh, method=method)
    return {"q": q.numpy(), "r": r.numpy(), **_log_arrays(log)}


def _mesh(shape: str | None = None, dcn: str | None = None):
    from dmd_era5_tpu_torch.parallel import make_hybrid_mesh, make_mesh

    if dcn is not None:
        return make_hybrid_mesh(shape, dcn, n_slices=2, device="cpu")
    return make_mesh(shape, device="cpu")


def fit_case(inputs, shape: str | None = None, dcn: str | None = None, k: int = 8,
             gemm: str = "float32", x: str = "x", omega: str = "omega") -> dict:
    import torch

    from dmd_era5_tpu_torch.parallel import MESH_AXES
    from dmd_era5_tpu_torch.parallel.collectives import collective_log
    from dmd_era5_tpu_torch.pipeline.train_step import make_fit_step

    mesh = _mesh(shape, dcn)
    step = make_fit_step(mesh, k, gemm_dtype=getattr(torch, gemm))
    with collective_log() as log:
        state = step(inputs[x], inputs[omega])
    out = {key: value.float().numpy() for key, value in state._asdict().items()}
    coords = np.asarray([mesh.coords[a] for a in MESH_AXES])
    return {**out, "coords": coords, **_log_arrays(log)}


def collectives_case(inputs) -> dict:
    """Every collective on this rank's blocks of the inputs (world 8)."""
    import torch

    from dmd_era5_tpu_torch.parallel import col_sharded, reshard, row_sharded, shard_rows
    from dmd_era5_tpu_torch.parallel import collectives as c
    from dmd_era5_tpu_torch.parallel.collectives import collective_log

    out = {}
    with collective_log() as log:
        grid = _mesh("data=2,space=4")
        blk = torch.from_numpy(inputs["blocks"][grid.coords["data"], grid.coords["space"]])
        out["psum"] = c.psum(blk, "space", grid).numpy()
        out["pmean"] = c.pmean(blk, "space", grid).numpy()
        out["psum_data"] = c.psum(blk, "data", grid).numpy()
        out["all_gather"] = c.all_gather(blk, "space", grid).numpy()
        out["all_gather_tiled"] = c.all_gather(blk, "space", grid, axis=1, tiled=True).numpy()
        out["axis"] = np.asarray([c.axis_index(a, grid) for a in ("data", "space")]
                                 + [c.axis_size(a, grid) for a in ("data", "space")])
        st = _mesh("space=2,time=4")
        row = torch.from_numpy(inputs["row"])[:, st.coords["time"] * 3:(st.coords["time"] + 1) * 3]
        out["ring"] = c.ring_permute(row, "time", st, shift=1).numpy()
        out["ring_back"] = c.ring_permute(row, "time", st, shift=-1).numpy()
        out["halo_left"] = c.halo_exchange_left(row, "time", st, halo=2, axis=1).numpy()
        out["halo_right"] = c.halo_exchange_right(row, "time", st, halo=2, axis=1).numpy()
        sp = _mesh("space=8")
        x_loc, rows = shard_rows(inputs["a2a"], sp)
        out["all_to_all"] = c.all_to_all(x_loc, "space", sp, split_axis=1, concat_axis=0).numpy()
        out["reshard"] = reshard(x_loc, row_sharded(sp), col_sharded(sp, axis="space")).numpy()
        out["shard_rows"] = shard_rows(inputs["odd"], sp)[0].numpy()
        out["rank"] = np.asarray(sp.rank)
    return {**out, **_log_arrays(log)}


def loader_case(inputs, path: str) -> dict:
    from dmd_era5_tpu_torch.snapmat.loader import load_row_sharded

    mesh = _mesh()
    block, rows = load_row_sharded(path, mesh)
    return {"block": block.float().numpy(), "dtype": np.asarray(str(block.dtype)),
            "rows": np.asarray(rows), "index": np.asarray(mesh.coords["space"])}


def env_case(inputs) -> dict:
    import torch.distributed as dist

    return {"rank": np.asarray(dist.get_rank()), "world": np.asarray(dist.get_world_size()),
            "backend": np.asarray(dist.get_backend())}


# ------------------------------------------------- the SVD layer (9b)


def _tensor(inputs, key: str | None):
    import torch

    return None if key is None else torch.from_numpy(np.ascontiguousarray(inputs[key]))


def _result(res, mesh, rows: int, d: int = 1, log=None) -> dict:
    """An SVDResult with U gathered to the host, delay-major."""
    from dmd_era5_tpu_torch.parallel import assemble_rows

    out = {"u": assemble_rows(res.U, mesh, d=d, rows=rows), "s": res.s.numpy(),
           "v": res.V.numpy()}
    return {**out, **(_log_arrays(log) if log is not None else {})}


def svd_case(inputs, op: str, x: str, k: int = 0, shape: str | None = None,
             omega: str | None = None, seed: int = 0, gemm: str = "float32",
             method: str | None = None, own_rows: bool = False) -> dict:
    """``ops.svd`` on this rank's row block (``shard_rows``, or with
    ``own_rows`` the rank's equal share, as the multi-process demo's
    processes hold theirs): ``op`` exact, gram, standard (the
    dispatcher), randomized, or tsqr (Q gathered, R, at ``method``)."""
    import torch

    from dmd_era5_tpu_torch.ops import svd as tsvd
    from dmd_era5_tpu_torch.ops.tsqr import tsqr
    from dmd_era5_tpu_torch.parallel import assemble_rows, shard_rows
    from dmd_era5_tpu_torch.parallel.collectives import collective_log

    mesh = _mesh(shape)
    arr = inputs[x]
    if own_rows:
        per = arr.shape[0] // mesh.shape["space"]
        i = mesh.coords["space"]
        x_loc, rows = torch.from_numpy(arr[i * per:(i + 1) * per].copy()), arr.shape[0]
    else:
        x_loc, rows = shard_rows(arr, mesh)
    with collective_log() as log:
        if op == "tsqr":
            q, r = tsqr(x_loc, mesh, method=method)
        elif op == "exact":
            res = tsvd.exact_truncated_svd(x_loc, k, mesh)
        elif op == "gram":
            res = tsvd.exact_truncated_svd_gram(x_loc, k, mesh=mesh)
        elif op == "standard":
            res = tsvd.truncated_svd(x_loc, k, "standard", mesh=mesh)
        else:
            res = tsvd.randomized_svd(x_loc, k, seed=seed, gemm_dtype=getattr(torch, gemm),
                                      mesh=mesh, omega=_tensor(inputs, omega))
    if op == "tsqr":
        return {"q": assemble_rows(q, mesh, rows=rows), "r": r.numpy(), **_log_arrays(log)}
    return _result(res, mesh, rows, log=log)


def grid_case(inputs, op: str, x: str, k: int, shape: str, omega: str | None = None,
              d: int = 1, t_valid: int | None = None, ingest: bool = False) -> dict:
    """The grid-sharded SVDs on this rank's (space, time) block:
    ``randomized_svd_2d`` (op svd2d) or ``hankel_randomized_svd_2d``
    (op hankel2d).  With ``ingest`` the block arrives as the stage's
    grid2d route makes it: the rank's rows of its space block
    (``load_row_sharded`` over time), then one ``all_to_all``."""
    import torch

    from dmd_era5_tpu_torch.ops.hankel import hankel_randomized_svd_2d
    from dmd_era5_tpu_torch.ops.svd import randomized_svd_2d
    from dmd_era5_tpu_torch.parallel import Layout, reshard
    from dmd_era5_tpu_torch.parallel.collectives import collective_log
    from dmd_era5_tpu_torch.snapmat.loader import load_row_sharded

    mesh = _mesh(shape)
    arr = inputs[x]
    with collective_log() as log:
        if ingest:
            per = arr.shape[0] // mesh.shape["space"]
            block = arr[mesh.coords["space"] * per:(mesh.coords["space"] + 1) * per]
            rows, _ = load_row_sharded(block, mesh, axis="time")
            x_loc = reshard(rows, Layout(mesh, ("time", None)), Layout(mesh, (None, "time")))
        else:
            x_loc = Layout(mesh, ("space", "time")).local_block(torch.from_numpy(arr)).contiguous()
        if op == "svd2d":
            res = randomized_svd_2d(x_loc, k, mesh, omega=_tensor(inputs, omega))
        else:
            res = hankel_randomized_svd_2d(x_loc, d, k, mesh, t_valid=t_valid,
                                           omega=_tensor(inputs, omega))
    return _result(res, mesh, arr.shape[0], d=d, log=log)


def hankel_case(inputs, op: str, x: str, d: int, k: int = 0, shape: str | None = None,
                omega: str | None = None, fused: bool = True, oversamples: int = 10) -> dict:
    """The space-sharded Hankel SVDs on this rank's row block (op
    sharded, exact), or the time-sharded operators on its column block
    (op sketch: Y, alike on every rank; op embed: the rank's block)."""
    import torch

    from dmd_era5_tpu_torch.ops import hankel
    from dmd_era5_tpu_torch.parallel import Layout, shard_rows
    from dmd_era5_tpu_torch.parallel.collectives import collective_log

    mesh = _mesh(shape)
    arr = inputs[x]
    if op in ("sketch", "embed"):
        x_loc = Layout(mesh, (None, "time")).local_block(torch.from_numpy(arr)).contiguous()
        with collective_log() as log:
            if op == "sketch":
                out = hankel.hankel_sketch_time_sharded(x_loc, _tensor(inputs, omega), d, mesh)
            else:
                out = hankel.delay_embed_time_sharded(x_loc, d, mesh)
        return {"out": out.numpy(), "index": np.asarray(mesh.coords["time"]), **_log_arrays(log)}
    x_loc, rows = shard_rows(arr, mesh)
    with collective_log() as log:
        if op == "sharded":
            res = hankel.hankel_randomized_svd_sharded(
                x_loc, d, k, mesh, n_oversamples=oversamples, fused=fused,
                omega=_tensor(inputs, omega))
        else:
            res = hankel.hankel_exact_svd(x_loc, d, k, mesh=mesh)
    return _result(res, mesh, rows, d=d, log=log)


def stage_case(inputs, config: str, stage_slice: str | None = None,
               resolve_only: bool = False) -> dict:
    """``era5_svd.main`` of the port on the CPU over the world (its mesh
    from the config, ``parallel.mesh_from_config``), under the root the
    job's environment names.  ``stage_slice``: rank 0 first writes the
    mock slice of that seed into the workdir (the port's mock and HDF5
    writer), and every rank waits for it, as the JAX multi-process stage
    demo does.  ``resolve_only``: the backend ``resolve_svd_backend``
    picks on the stage mesh, nothing computed."""
    import torch.distributed as dist

    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.parallel import mesh_from_config
    from dmd_era5_tpu_torch.pipeline import era5_download, era5_svd

    cfg = json.loads(config)
    parsed = config_parser(dict(cfg), "era5-svd")
    if resolve_only:
        mesh = mesh_from_config(parsed, device="cpu")
        return {"backend": np.asarray(era5_svd.resolve_svd_backend(parsed, mesh=mesh))}
    if stage_slice is not None:
        if dist.get_rank() == 0:
            from dmd_era5_tpu_torch.snapmat import create_mock_era5
            from dmd_era5_tpu_torch.utils.io_h5 import save_fieldset

            fs = create_mock_era5(parsed["start_datetime"], parsed["end_datetime"],
                                  parsed["variables"], parsed["levels"], seed=int(stage_slice))
            save_fieldset(era5_download.add_config_attributes(fs, parsed),
                          parsed["era5_slice_path"])
        dist.barrier()
    res, _, _ = era5_svd.main(cfg, write_artifact=False, device="cpu")
    out = {key: np.asarray(res[key].values) for key in ("U", "s", "V", "X")
           if key in res.data_vars}
    return {**out, "backend": np.asarray(res.attrs["svd_backend"])}


def stage_fails_case(inputs, config: str, root: str, write_artifact: bool = False) -> dict:
    """``era5_svd.main`` of the port under ``root``, where the test has put
    a file in the place of the stage's directory, so that rank 0's write
    (the artifact, or the inmem route's packed matrix) fails: the error
    this rank raised, '' if none."""
    before = os.environ.get("DMD_ERA5_TPU_ROOT")
    os.environ["DMD_ERA5_TPU_ROOT"] = root
    try:
        from dmd_era5_tpu_torch.pipeline import era5_svd

        era5_svd.main(json.loads(config), write_artifact=write_artifact, device="cpu")
        error = ""
    except Exception as err:
        error = f"{type(err).__name__}: {err}"
    finally:
        os.environ["DMD_ERA5_TPU_ROOT"] = before
    return {"error": np.asarray(error)}


# ------------------------------------------------ the models on a mesh (9c)


def bag_case(inputs, shape: str, u: str, s: str, v: str, t: str, rank: int, n_trials: int,
             trial_fraction: float, seed: int = 0, max_iter: int = 50) -> dict:
    """``bopdmd_from_svd`` with the trials over the mesh's ``data`` axis,
    on the whole factors (alike on every rank), and its collective log."""
    from dmd_era5_tpu_torch.models import bopdmd_from_svd
    from dmd_era5_tpu_torch.parallel.collectives import collective_log

    mesh = _mesh(shape)
    args = [_tensor(inputs, key) for key in (u, s, v, t)]
    with collective_log() as log:
        res = bopdmd_from_svd(*args, rank=rank, n_trials=n_trials, trial_fraction=trial_fraction,
                              seed=seed, max_iter=max_iter, mesh=mesh)
    out = {key: getattr(res, key).numpy() for key in (
        "eigenvalues", "eigenvalues_std", "amplitudes", "amplitudes_std", "modes", "modes_std",
        "trial_eigenvalues", "n_iters")}
    return {**out, **_log_arrays(log)}


def _member_fieldset(inputs, fields: str, memmap: str | None):
    """The port's FieldSet of the test's fields: (time, level, lat, lon)
    arrays named ``<fields>.var.<variable>`` (coordinates
    ``<fields>.coord.<dim>``), or with ``memmap`` the
    (level, lat, lon, time) ``.npy`` files ``<memmap>/<variable>.npy``
    opened read-only as memmaps."""
    from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

    coords = {name: Coord(name, inputs[f"{fields}.coord.{name}"])
              for name in ("time", "level", "latitude", "longitude")}
    names = ([key.split(".var.", 1)[1] for key in inputs if key.startswith(f"{fields}.var.")]
             if memmap is None else sorted(path.stem for path in Path(memmap).glob("*.npy")))
    out = {}
    for name in names:
        if memmap is None:
            out[name] = Field(inputs[f"{fields}.var.{name}"],
                              ("time", "level", "latitude", "longitude"), coords, name=name)
        else:
            out[name] = Field(np.load(f"{memmap}/{name}.npy", mmap_mode="r"),
                              ("level", "latitude", "longitude", "time"), coords, name=name)
    return FieldSet(out)


def ensemble_case(inputs, shape: str, fields: str, k: int, omega: str,
                  memmap: str | None = None, solve_dmd: bool = False,
                  dmd_max_iter: int = 50) -> dict:
    """``fit_per_variable_level`` on the mesh (the test's sketch), the
    state whole on every rank, and its collective log."""
    from dmd_era5_tpu_torch.parallel.collectives import collective_log
    from dmd_era5_tpu_torch.pipeline import fit_per_variable_level

    mesh = _mesh(shape)
    fs = _member_fieldset(inputs, fields, memmap)
    with collective_log() as log:
        fit = fit_per_variable_level(fs, k, mesh=mesh, omega=inputs[omega], solve_dmd=solve_dmd,
                                     dmd_max_iter=dmd_max_iter)
    out = {key: value.float().numpy() for key, value in fit.state._asdict().items()}
    out["labels"] = np.asarray([f"{var}:{lev}" for var, lev in fit.labels])
    if solve_dmd:
        out.update({f"dmd_{key}": getattr(fit.dmd, key).numpy()
                    for key in ("alpha", "amplitudes", "residual")})
    return {**out, **_log_arrays(log)}


def dmdc_case(inputs, shape: str, x: str, u: str, rank: int, factors: bool = False) -> dict:
    """``fit_dmdc`` (or with ``factors`` ``dmdc_from_svd`` on the test's
    u, s and v of ``x``) with its SVDs over the mesh's ``space`` axis."""
    from dmd_era5_tpu_torch.models import dmdc_from_svd, fit_dmdc
    from dmd_era5_tpu_torch.parallel.collectives import collective_log

    mesh = _mesh(shape)
    with collective_log() as log:
        if factors:
            res = dmdc_from_svd(*(_tensor(inputs, f"{x}_{key}") for key in ("u", "s", "v")),
                                inputs[u], rank=rank, mesh=mesh)
        else:
            res = fit_dmdc(inputs[x], inputs[u], rank=rank, mesh=mesh)
    out = {key: getattr(res, key).numpy() for key in (
        "eigenvalues", "modes", "a_red", "b_red", "u_hat")}
    return {**out, "residual": np.asarray(res.residual), **_log_arrays(log)}


def lm_case(inputs, shape: str, h: str, t: str, alpha0: str, max_iter: int) -> dict:
    """``varpro_lm_batched`` with the members over the mesh's ``data`` axis."""
    from dmd_era5_tpu_torch.models import varpro_lm_batched

    out = varpro_lm_batched(inputs[h], inputs[t], inputs[alpha0], max_iter=max_iter,
                            mesh=_mesh(shape))
    return dict(zip(("alpha", "b", "rel", "n_iters"), out))


def dmd_stage_case(inputs, config: str, shape: str | None, write_artifact: bool = True,
                   use_store: bool = False, root: str | None = None) -> dict:
    """``era5_dmd.main`` of the port on the mesh ``shape`` over the world
    (None: the SVD stage's default mesh, the fit on one device), under
    ``root`` or the root the job's environment names (the slice staged
    there by the test): its results' small fields and modes, whether this
    rank added to the store, the error it raised ('' if none)."""
    from dmd_era5_tpu_torch.pipeline import era5_dmd

    before = os.environ.get("DMD_ERA5_TPU_ROOT")
    if root is not None:
        os.environ["DMD_ERA5_TPU_ROOT"] = root
    try:
        mesh = None if shape is None else _mesh(shape)
        res, added, _ = era5_dmd.main(json.loads(config), write_artifact=write_artifact,
                                      use_store=use_store, mesh=mesh, device="cpu")
    except Exception as err:
        return {"error": np.asarray(f"{type(err).__name__}: {err}")}
    finally:
        if before is not None:
            os.environ["DMD_ERA5_TPU_ROOT"] = before
    out = {key: np.asarray(res[key].values) for key in (
        "eigenvalues", "amplitudes", "eigenvalues_std", "amplitudes_std", "modes", "modes_std",
        "dmdc_eigenvalues", "dmdc_a_red", "dmdc_b_red", "dmdc_modes", "forecast")
        if key in res.data_vars}
    return {**out, "trials_used": np.asarray(res.attrs["bagging_trials_used"]),
            "added": np.asarray(added), "error": np.asarray("")}


def main(job_path: str, rank: int) -> None:
    import torch.distributed as dist

    from dmd_era5_tpu_torch.parallel import initialize_distributed

    job = json.loads(Path(job_path).read_text())
    if job["init"] == "env":  # torchrun's variables, set by the test
        initialize_distributed(device="cpu", timeout_s=60)
    else:
        initialize_distributed(init_method=job["init"], world_size=job["world"], rank=rank,
                               device="cpu", timeout_s=60)
    inputs = dict(np.load(job["inputs"]))
    results = {}
    for case in job["cases"]:
        out = globals()[case["fn"]](inputs, **case.get("args", {}))
        results.update({f"{case['name']}/{key}": value for key, value in out.items()})
    dist.barrier()
    dist.destroy_process_group()
    np.savez(job["out"].format(rank=rank), **results)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
