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
    the ranks then start their group from the environment alone."""

    def __init__(self, world: int, cases: list[dict], inputs: dict, directory: Path,
                 timeout: float = 120.0, env_of_rank=None):
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
        env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
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
