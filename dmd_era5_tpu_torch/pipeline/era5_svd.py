"""The SVD stage: its dispatcher and its ``main``, on one device or a mesh.

The port's counterpart of ``dmd_era5_tpu/pipeline/era5_svd.py``:
:func:`resolve_svd_backend` against the mesh, the ``hankel``,
``grid2d``, ``streamed``, ``onepass`` and ``inmem`` backends behind
:func:`svd_on_era5`, :func:`combine_svd_results`, and the stage's
:func:`main` with its cache ladder (workdir attr match, then the
artifact store, then compute) and artifact write.  :func:`main` calls
:func:`compute_svd_results` between the ladder and the write: the slice
is selected, sliced and resampled on the host (views where the selection
allows), the forecast holdout split off there, the training fields moved
to the device once and flattened and standardized there, and the
factors come back as host (numpy) arrays, as the JAX function returns
them.

The stage mesh is ``parallel.mesh_from_config`` over the process
group's world (one process: a (1, 1, 1) mesh; a ``mesh_shape`` whose
product is not the world's size raises ``ValueError``).  Every rank runs
the stage on the whole slice, as every JAX process does; the SVD then
runs on the rank's block (``shard_rows``, a grid block, or its rows of a
packed file for the multi-process ``inmem`` route), and U is gathered to
each rank's host (``parallel.assemble_rows``) only here.  In a world of
several ranks rank 0 alone writes the packed files and the artifact.

The snapshot matrix comes in a ``Field`` whose data is a numpy array or
a tensor; a tensor on the chosen device is used where it lies, never
copied to the host.

Run as ``python -m dmd_era5_tpu_torch.pipeline.era5_svd``.
"""

from __future__ import annotations

import functools
import math
import os
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from dmd_era5_tpu_torch.core import config_parser, config_reader
from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.ops.hankel import (
    hankel_exact_svd,
    hankel_randomized_svd_2d,
    hankel_randomized_svd_fused,
    hankel_randomized_svd_sharded,
)
from dmd_era5_tpu_torch.ops.svd import randomized_svd_2d, truncated_svd
from dmd_era5_tpu_torch.parallel.mesh import AXIS_SPACE, AXIS_TIME, Mesh, mesh_from_config
from dmd_era5_tpu_torch.parallel.sharding import Layout, assemble_rows, reshard, shard_rows
from dmd_era5_tpu_torch.pipeline.artifacts import add_data_to_store, retrieve_data_from_store
from dmd_era5_tpu_torch.pipeline.streamed_fit import (
    streamed_exact_gram_svd,
    streamed_onepass_svd,
    streamed_randomized_svd,
)
from dmd_era5_tpu_torch.snapmat.loader import load_row_sharded, save_packed_matrix
from dmd_era5_tpu_torch.snapmat.slicing import resample_era5_dataset, slice_era5_dataset
from dmd_era5_tpu_torch.snapmat.transform import (
    apply_delay_embedding,
    delay_embedded_coords,
    flatten_era5_variables,
    space_coord_to_level_lat_lon,
    standardize_rows,
)
from dmd_era5_tpu_torch.utils.io_h5 import load_fieldset, save_fieldset
from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

__all__ = [
    "HBM_BUDGET_ENV",
    "add_config_attributes",
    "check_era5_slice",
    "check_svd_results",
    "combine_svd_results",
    "compute_svd_results",
    "main",
    "resolve_svd_backend",
    "retrieve_era5_slice",
    "retrieve_svd_results",
    "svd_on_era5",
]

# The per-device memory budget of ``svd_backend = auto``, in GB, and the
# variable that overrides it: the JAX package's, whose 12 GB default was
# set for a TPU v5e.  Kept, so that auto routes every configuration the
# way the JAX package does (ROADMAP Queue 3).
HBM_BUDGET_ENV = "DMD_ERA5_TPU_HBM_BUDGET_GB"
_HBM_BUDGET_GB = 12.0


@functools.cache
def _logger():
    return setup_logger("ERA5-SVD-torch", "era5_svd_torch.log")


def _world() -> tuple[int, int]:
    """(this process's rank, the world's size): (0, 1) without a group."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if _world()[1] > 1:
        torch.distributed.barrier()


def _on_rank0(fn):
    """``fn()`` on rank 0 alone; in a world of several ranks every rank
    then learns its outcome (one ``broadcast_object_list``, which the
    others wait on as on a barrier) and raises if it failed, so no rank
    is left waiting on one that has stopped.  Returns fn's result on
    rank 0, None on the others."""
    rank, size = _world()
    result, failure = None, None
    if rank == 0:
        try:
            result = fn()
        except Exception as err:
            if size == 1:
                raise
            failure = err
    if size > 1:
        box = [None if failure is None else f"{type(failure).__name__}: {failure}"]
        torch.distributed.broadcast_object_list(box, src=0)
        if failure is not None:
            raise failure
        if box[0] is not None:
            raise RuntimeError(f"rank 0 failed: {box[0]}")
    return result


def _over_hbm_budget(parsed_config: dict, have_flat: bool, d: int, space_shards: int) -> bool:
    """Whether a space shard's part of the f32 matrix and its factor
    arrays exceed the per-device budget
    (``dmd_era5_tpu/pipeline/era5_svd.py:253-285``)."""
    n_rows = parsed_config.get("_matrix_rows")
    t_cols = parsed_config.get("_matrix_cols")
    if not (have_flat and n_rows and t_cols):
        return False
    budget = float(os.environ.get(HBM_BUDGET_ENV, _HBM_BUDGET_GB))
    k = parsed_config.get("n_components", 0) + 28
    if n_rows * d / space_shards * (t_cols + 2 * k) * 4 <= budget * 1e9:
        return False
    route = "(2-pass exact Gram route)." if parsed_config["svd_type"] != "randomized" \
        else "(power-iteration schedule)."
    log_and_print(
        _logger(),
        f"matrix {n_rows * d} x {t_cols} exceeds the {budget:.0f} GB/device HBM "
        f"budget in memory — routing svd_backend=auto to the out-of-core "
        f"streamed backend {route}",
    )
    return True


def resolve_svd_backend(parsed_config: dict, have_flat: bool = True,
                        mesh: Mesh | None = None) -> str:
    """Resolve ``svd_backend = auto`` against the config and the mesh
    (``dmd_era5_tpu/pipeline/era5_svd.py:214``; no mesh: one device).

    auto picks the Hankel-operator path for delay d > 1 (both svd
    types; the embedded matrix never exists), else for a randomized SVD
    on a time-sharded mesh ``grid2d``, else the out-of-core streamed
    backend past the memory budget of a space shard, else inmem.  A
    standard SVD on a time-sharded mesh warns: it shards over space
    only.  An explicit grid2d with d > 1 (randomized, flat matrix given)
    reroutes to the Hankel path, as in the JAX package.
    """
    backend = parsed_config.get("svd_backend", "auto")
    svd_type = parsed_config["svd_type"]
    d = int(parsed_config.get("delay_embedding", 1))
    shape = mesh.shape if mesh is not None else {}
    time_shards = shape.get(AXIS_TIME, 1)
    space_shards = max(shape.get(AXIS_SPACE, 1), 1)
    if backend != "auto":
        if backend == "grid2d" and d > 1 and have_flat and svd_type == "randomized":
            log_and_print(
                _logger(),
                "svd_backend='grid2d' with delay_embedding > 1 routes through "
                "the Hankel-operator path (the embedded matrix never materializes).",
            )
            return "hankel"
        return backend
    if svd_type != "randomized" and time_shards > 1:
        log_and_print(
            _logger(),
            f"mesh has time={time_shards} but svd_type='standard' only shards over "
            "space — the time axis computes replicated work. Use "
            "svd_type='randomized' (backend grid2d) to use a time-sharded mesh.",
            "warning",
        )
    if d > 1 and have_flat:
        return "hankel"
    if svd_type == "randomized" and time_shards > 1:
        return "grid2d"
    if _over_hbm_budget(parsed_config, have_flat, d, space_shards):
        return "streamed"
    return "inmem"


def _device(device, field: Field | None) -> torch.device:
    """The device the stage runs on: ``device`` when given, else that of
    a tensor in ``field``, else the card (which must be present)."""
    if device is not None:
        return torch.device(device)
    if field is not None and isinstance(field.data, torch.Tensor):
        return field.data.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the stage runs on a CUDA card and none is available; pass "
            "device='cpu' (or a CPU tensor) to run it on the host"
        )
    return torch.device("cuda")


def _as_tensor(data, device: torch.device) -> torch.Tensor:
    """Field data as an f32 tensor on ``device``: a tensor already there
    in f32 is returned as it is; a host array is copied once."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.float32)
    arr = np.asarray(data, dtype=np.float32)
    if not arr.flags.writeable:  # torch wraps only writable arrays
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _host(*arrays) -> tuple[np.ndarray, ...]:
    """Factors as float32 host arrays, tensors copied from their device."""
    return tuple(
        a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor)
        else np.asarray(a, dtype=np.float32)
        for a in arrays
    )


def _svd_backend_hankel(da_flat: Field, parsed_config: dict, mesh: Mesh, d: int, k: int):
    """Operator-form SVD of H_d(X), the embedded matrix never built
    (``dmd_era5_tpu/pipeline/era5_svd.py:313``).

    randomized: one space shard -> ``hankel_randomized_svd_fused`` (GEMMs
    in the stage's precision); a time-sharded mesh ->
    ``hankel_randomized_svd_2d`` on the rank's grid block (zero-padded
    rows and columns, the columns cut by ``t_valid``); else
    ``hankel_randomized_svd_sharded`` (fused, the stage's precision) on
    the rank's row block.  standard: ``hankel_exact_svd``, one device or
    space-sharded (time shards compute alike).  Zero pad rows drop out
    of every product; their rows of U are cut inside each delay block
    (``parallel.assemble_rows``)."""
    x = _as_tensor(da_flat.data, mesh.device)
    s_rows, t_cols = x.shape
    n_space, n_time = mesh.shape[AXIS_SPACE], mesh.shape[AXIS_TIME]
    gemm_dtype = torch.bfloat16 if parsed_config.get("precision") == "bfloat16" else torch.float32
    if parsed_config["svd_type"] != "randomized":
        if n_space == 1:
            return _host(*hankel_exact_svd(x, d, k))
        res = hankel_exact_svd(shard_rows(x, mesh)[0], d, k, mesh=mesh)
    elif n_time > 1:
        x_pad = torch.nn.functional.pad(x, (0, (-t_cols) % n_time, 0, (-s_rows) % n_space))
        x_loc = Layout(mesh, (AXIS_SPACE, AXIS_TIME)).local_block(x_pad).contiguous()
        del x_pad
        res = hankel_randomized_svd_2d(x_loc, d, k, mesh, t_valid=t_cols)
    elif n_space == 1:
        return _host(*hankel_randomized_svd_fused(x, d, k, gemm_dtype=gemm_dtype))
    else:
        res = hankel_randomized_svd_sharded(shard_rows(x, mesh)[0], d, k, mesh,
                                            gemm_dtype=gemm_dtype)
    return (assemble_rows(res.U, mesh, d=d, rows=s_rows), *_host(res.s, res.V))


def _svd_backend_grid2d(x: np.ndarray, mesh: Mesh, k: int, gemm_dtype: torch.dtype):
    """The (space x time) grid-sharded randomized SVD of the embedded
    host matrix x (``dmd_era5_tpu/pipeline/era5_svd.py:396``).

    Ingest lands row-sharded: each rank reads its 1/(space * time) of
    the rows (``load_row_sharded`` over the time ranks of its space
    block), and one ``all_to_all`` over time (``parallel.reshard``, the
    Ulysses swap) turns that into the rank's grid block.  Rows and
    columns are zero-padded up to the mesh; zero columns add nothing to
    any product, so the padded tail of V is zero and is cut.
    """
    n_rows, t_cols = x.shape
    sp, tp = mesh.shape[AXIS_SPACE], mesh.shape[AXIS_TIME]
    x = np.pad(x, ((0, (-n_rows) % (sp * tp)), (0, (-t_cols) % tp)))
    per = x.shape[0] // sp
    block = x[mesh.coords[AXIS_SPACE] * per : (mesh.coords[AXIS_SPACE] + 1) * per]
    rows, _ = load_row_sharded(block, mesh, axis=AXIS_TIME)
    x_loc = reshard(rows, Layout(mesh, (AXIS_TIME, None)), Layout(mesh, (None, AXIS_TIME)))
    del rows
    res = randomized_svd_2d(x_loc, k, mesh, gemm_dtype=gemm_dtype)
    return assemble_rows(res.U, mesh, rows=n_rows), *_host(res.s, res.V[:, :t_cols])


def _svd_backend_inmem_multihost(da_flat: Field, parsed_config: dict, mesh: Mesh, d: int,
                                 k: int, svd_type: str, gemm_dtype: torch.dtype):
    """The multi-process ``inmem`` route
    (``dmd_era5_tpu/pipeline/era5_svd.py:487``): rank 0 writes the packed
    delay-slab matrix (``<save_path>.packed.npy``; if that fails, every
    rank raises with it), every rank reads only
    its rows of it (``load_row_sharded``), the meshed ``truncated_svd``
    runs over space, and U is gathered so that every rank packages it."""
    packed = Path(str(parsed_config["save_path"]) + ".packed.npy")
    rank, _ = _world()
    _on_rank0(lambda: save_packed_matrix(packed, da_flat.data, d=d))
    try:
        xs, n_rows = load_row_sharded(packed, mesh, axis=AXIS_SPACE)
        res = truncated_svd(xs, k, svd_type=svd_type, gemm_dtype=gemm_dtype, mesh=mesh,
                            axis_name=AXIS_SPACE)
        del xs
        u = assemble_rows(res.U, mesh, rows=n_rows)
        s, v = _host(res.s, res.V)
        _barrier()  # every rank has read the file
    finally:
        if rank == 0:
            packed.unlink(missing_ok=True)
    return u, s, v


def _svd_backend_streamed(
    da: Field | None, da_flat: Field | None, parsed_config: dict, device, d: int, k: int,
    onepass: bool = False,
):
    """Out-of-core: pack X (the d delay slabs of the flat matrix, so the
    Hankel copy never exists in host memory) into ``<save_path>.packed.
    npy``, stream it through the one-pass sketch (``onepass``), the exact
    Gram route (``svd_type = standard``) or the randomized power
    schedule, and remove it.  Returns (U, s, V, info): ``info`` holds the
    one-pass route's ``onepass_tail_rel_err_est``."""
    rank, world = _world()
    suffix = f".rank{rank}" if world > 1 else ""  # every rank streams its own copy
    packed_path = Path(str(parsed_config["save_path"]) + f"{suffix}.packed.npy")
    src = da_flat if da_flat is not None else da
    x = src.data if isinstance(src.data, torch.Tensor) else _as_tensor(src.data, torch.device("cpu"))
    save_packed_matrix(packed_path, x, d=d if da_flat is not None else 1)
    block_rows = int(parsed_config.get("stream_block_rows", 1 << 16))
    info: dict = {}
    try:
        if onepass:
            res = streamed_onepass_svd(packed_path, k, block_rows=block_rows, device=device,
                                       info=info)
        elif parsed_config["svd_type"] == "standard":
            res = streamed_exact_gram_svd(packed_path, k, block_rows=block_rows, device=device)
        else:
            res = streamed_randomized_svd(packed_path, k, block_rows=block_rows, device=device)
    finally:
        packed_path.unlink(missing_ok=True)
    return (*_host(*res), info)


def _embedded(da: Field | None, da_flat: Field | None, d: int, device) -> torch.Tensor:
    """The delay-embedded matrix on ``device``, built there from d
    column slices of the flat one when only that is given."""
    if da is not None:
        return _as_tensor(da.data, device)
    if da_flat is None:
        raise ValueError("svd_on_era5 needs da or da_flat")
    x = _as_tensor(da_flat.data, device)
    t_out = x.shape[1] - d + 1
    if t_out < 1:
        raise ValueError("Delay embedding longer than the time series.")
    return x if d == 1 else torch.cat([x[:, j : j + t_out] for j in range(d)], dim=0)


def svd_on_era5(
    da: Field | None,
    parsed_config: dict,
    device: torch.device | str | None = None,
    da_flat: Field | None = None,
    mesh: Mesh | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Truncated SVD of the preprocessed snapshot matrix on the mesh.

    ``da`` is the materialized embedded matrix (may be None when
    ``da_flat``, the un-embedded (S, T) matrix, is given).  Backends:
    ``inmem`` (``truncated_svd`` of the embedded matrix; over several
    ranks each reads its rows of a packed file), ``hankel`` (delay
    operators on ``da_flat``), ``grid2d`` (the (space x time) grid),
    ``streamed`` (out-of-core), ``onepass`` (out-of-core in one pass over
    the packed matrix; its ``onepass_tail_rel_err_est`` joins the
    metrics).  ``mesh``: default ``parallel.mesh_from_config`` over the
    world on ``device`` (the card unless given, or unless the matrix is a
    tensor on another device); every rank of the world calls this.
    Returns host arrays (U, s, V), alike on every rank, and records
    ``svd_backend``, ``svd_seconds`` (after the device synchronizes) and
    ``svd_gelem_per_s`` in ``parsed_config["metrics"]``.
    """
    svd_type = parsed_config["svd_type"]
    n_components = parsed_config["n_components"]
    d = int(parsed_config.get("delay_embedding", 1))
    gemm_dtype = torch.bfloat16 if parsed_config.get("precision") == "bfloat16" else torch.float32
    if mesh is None:
        device = _device(device, da_flat if da_flat is not None else da)
        mesh = mesh_from_config(parsed_config, device=device)
    device = mesh.device
    if da_flat is not None:
        parsed_config["_matrix_rows"] = int(da_flat.data.shape[0])
        parsed_config["_matrix_cols"] = int(da_flat.data.shape[1])
    backend = resolve_svd_backend(parsed_config, have_flat=da_flat is not None, mesh=mesh)
    log_and_print(_logger(), f"Performing {svd_type} SVD (backend={backend}) on mesh "
                             f"{mesh.shape} ({device})...")

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    synchronize()
    t_start = time.perf_counter()
    if backend == "hankel":
        if da_flat is None:
            raise ValueError(
                "svd_backend='hankel' needs the un-embedded matrix (da_flat); "
                "the stage main provides it."
            )
        u, s, v = _svd_backend_hankel(da_flat, parsed_config, mesh, d, n_components)
    elif backend == "grid2d":
        if svd_type != "randomized":
            raise ValueError("svd_backend='grid2d' requires svd_type='randomized'")
        x_host = _host(_embedded(da, da_flat, d, device))[0]
        u, s, v = _svd_backend_grid2d(x_host, mesh, n_components, gemm_dtype)
        del x_host
    elif backend in ("streamed", "onepass"):
        if da is None and da_flat is None:
            raise ValueError("svd_on_era5 needs da or da_flat")
        u, s, v, stream_info = _svd_backend_streamed(
            da, da_flat, parsed_config, device, d, n_components, onepass=backend == "onepass")
    elif backend == "inmem" and _world()[1] > 1:
        if da_flat is None:
            raise ValueError("multi-process inmem SVD needs the un-embedded matrix "
                             "(da_flat); the stage main provides it.")
        u, s, v = _svd_backend_inmem_multihost(da_flat, parsed_config, mesh, d, n_components,
                                               svd_type, gemm_dtype)
    elif backend == "inmem":
        x_embedded = _embedded(da, da_flat, d, device)
        u, s, v = _host(*truncated_svd(
            x_embedded, n_components, svd_type=svd_type, gemm_dtype=gemm_dtype
        ))
        del x_embedded
    else:
        raise ValueError(f"SVD backend {backend} is not supported.")
    synchronize()
    elapsed = time.perf_counter() - t_start

    if da_flat is not None:
        elems = math.prod(da_flat.shape) * (1 if backend == "hankel" else d)
    else:
        elems = math.prod(da.shape)
    parsed_config["metrics"] = {
        "svd_backend": backend,
        "svd_seconds": round(elapsed, 4),
        "svd_gelem_per_s": round(elems / elapsed / 1e9, 6),
    }
    if backend in ("streamed", "onepass"):
        # onepass: the sketches' tail-error estimate, into the artifact's attrs
        parsed_config["metrics"].update(stream_info)
    log_and_print(
        _logger(),
        f"{svd_type} SVD complete ({backend}): {elapsed:.3f}s, "
        f"{elems / elapsed / 1e9:.4f} Gelem/s.",
    )
    return u, s, v


def combine_svd_results(
    U: np.ndarray,
    s: np.ndarray,
    V: np.ndarray,
    coords,
    **kwargs: Field | None,
) -> FieldSet:
    """Package U/s/V (+ optional X, X_mean, X_std) into a FieldSet with
    the JAX stage's schema (``dmd_era5_tpu/pipeline/era5_svd.py:670``)."""
    components = np.arange(U.shape[1])
    u_field = Field(
        U,
        dims=("space", "components"),
        coords={
            "space": Coord("space", coords["space"].values),
            "components": Coord("components", components),
            "original_variable": Coord("space", coords["original_variable"].values),
            "delay": Coord("space", coords["delay"].values),
        },
        name="U",
    )
    s_field = Field(
        s,
        dims=("components",),
        coords={"components": Coord("components", np.arange(s.shape[0]))},
        name="s",
    )
    v_field = Field(
        V,
        dims=("components", "time"),
        coords={
            "components": Coord("components", np.arange(V.shape[0])),
            "time": Coord("time", coords["time"].values),
        },
        name="V",
    )
    data_vars: dict[str, Field] = {"U": u_field, "s": s_field, "V": v_field}
    for key in ("X", "X_mean", "X_std"):
        value = kwargs.get(key)
        if value is not None:
            data_vars[key] = value.copy()
            data_vars[key].name = key
    return FieldSet(data_vars)


def add_config_attributes(fs: FieldSet, parsed_config: dict) -> FieldSet:
    """Stamp decomposition provenance."""
    fs.attrs["source_path"] = parsed_config["source_path"]
    fs.attrs["n_components"] = parsed_config["n_components"]
    fs.attrs["variables"] = list(parsed_config["variables"])
    fs.attrs["levels"] = list(parsed_config["levels"])
    fs.attrs["mean_center"] = int(parsed_config["mean_center"])
    fs.attrs["scale"] = int(parsed_config["scale"])
    fs.attrs["delay_embedding"] = parsed_config["delay_embedding"]
    fs.attrs["svd_type"] = parsed_config["svd_type"]
    fs.attrs["era5_slice_path"] = parsed_config["era5_slice_path"]
    fs.attrs["date_processed"] = datetime.now().isoformat()
    fs.attrs["save_data_matrix"] = int(parsed_config["save_data_matrix"])
    fs.attrs["forecast_holdout"] = int(parsed_config.get("forecast_holdout", 0))
    return fs


def _as_str_list(value) -> list[str]:
    if isinstance(value, str):
        return [value]
    return [str(v) for v in value]


def _as_int_list(value) -> list[int]:
    if isinstance(value, (int, np.integer)):
        return [int(value)]
    return [int(v) for v in np.asarray(value).tolist()]


def check_era5_slice(fs: FieldSet, parsed_config: dict) -> bool:
    """Superset-tolerant slice match: the workdir slice is valid if the
    requested variables and levels are subsets of what it contains and
    the source matches."""
    attrs = fs.attrs
    want_vars = sorted(parsed_config["variables"])
    want_levels = sorted(parsed_config["levels"])
    have_vars = set(_as_str_list(attrs.get("variables", [])))
    have_levels = set(_as_int_list(attrs.get("levels", [])))
    return (
        want_vars == sorted(have_vars & set(want_vars))
        and want_levels == sorted(have_levels & set(want_levels))
        and parsed_config["source_path"] == attrs.get("source_path")
    )


def check_svd_results(fs: FieldSet, parsed_config: dict) -> bool:
    """Exact-config SVD match; an artifact with non-finite singular
    values is rejected, so a corrupt cached file is recomputed."""
    attrs = fs.attrs
    if "s" in fs.data_vars and not np.isfinite(np.asarray(fs["s"].data)).all():
        return False
    return (
        parsed_config["source_path"] == attrs.get("source_path")
        and parsed_config["n_components"] == attrs.get("n_components")
        and list(parsed_config["variables"]) == _as_str_list(attrs.get("variables", []))
        and list(parsed_config["levels"]) == _as_int_list(attrs.get("levels", []))
        and int(parsed_config["mean_center"]) == attrs.get("mean_center")
        and int(parsed_config["scale"]) == attrs.get("scale")
        and parsed_config["delay_embedding"] == attrs.get("delay_embedding")
        and parsed_config.get("forecast_holdout", 0) == attrs.get("forecast_holdout", 0)
    )


def _retrieve(
    parsed_config: dict,
    use_store: bool,
    path_key: str,
    data_type: str,
    checker,
    label: str,
) -> tuple[FieldSet | None, bool]:
    """The workdir -> store retrieval ladder shared by slice and results."""
    logger = _logger()

    def from_store() -> FieldSet | None:
        log_and_print(logger, f"Attempting to retrieve {label} from store...")
        try:
            retrieve_data_from_store(parsed_config, data_type=data_type)
            log_and_print(logger, f"{label} retrieved: {parsed_config[path_key]}")
            fs = load_fieldset(parsed_config[path_key])
        except (FileNotFoundError, ValueError) as err:
            log_and_print(logger, f"Could not retrieve {label} from store: {err}", "warning")
            return None
        # the store's match keys are a coarser filter than the full
        # checker (and say nothing about corruption): validate the
        # retrieved artifact exactly like a workdir hit
        if not checker(fs, parsed_config):
            log_and_print(
                logger,
                f"Store-retrieved {label} does not match configuration; recomputing.",
                "warning",
            )
            return None
        return fs

    if os.path.exists(parsed_config[path_key]):
        log_and_print(logger, f"{label} found in working directory.")
        fs = load_fieldset(parsed_config[path_key])
        if checker(fs, parsed_config):
            log_and_print(logger, f"{label} matches configuration.")
            return fs, False
        log_and_print(logger, f"{label} does not match configuration.")
        if use_store:
            fs = from_store()
            return fs, fs is not None
        log_and_print(
            logger, f"{label} in working directory does not match configuration.", "warning"
        )
        return None, False

    log_and_print(logger, f"{label} not found in working directory.", "warning")
    if use_store:
        fs = from_store()
        return fs, fs is not None
    return None, False


def retrieve_era5_slice(parsed_config: dict, use_store: bool = False) -> tuple[FieldSet | None, bool]:
    return _retrieve(
        parsed_config, use_store, "era5_slice_path", "era5_slice", check_era5_slice, "ERA5 slice"
    )


def retrieve_svd_results(parsed_config: dict, use_store: bool = False) -> tuple[FieldSet | None, bool]:
    return _retrieve(
        parsed_config, use_store, "save_path", "era5_svd", check_svd_results, "SVD results"
    )


def _holdout_truth_fields(ds_holdout: FieldSet, persist_raw: FieldSet) -> dict[str, Field]:
    """The raw physical holdout block for the DMD stage's scorer.

    Returns ``holdout_truth`` (S, h) and ``holdout_persistence`` (S,),
    the last raw train snapshot (the no-skill baseline), as host arrays
    (copied from the device where the slice's fields are tensors there)
    on a dedicated ``space_out`` axis (undelayed rows) with the
    level/lat/lon/variable row coordinates pre-split for HDF5.
    """
    truth_flat = flatten_era5_variables(ds_holdout)  # (S, h) raw
    persist_flat = flatten_era5_variables(persist_raw)  # (S, 1) raw
    tuples = truth_flat.coords["space"].values
    index = np.arange(len(tuples), dtype=int)
    coords = {
        "space_out": Coord("space_out", index),
        "level_out": Coord("space_out", np.asarray([t[0] for t in tuples])),
        "latitude_out": Coord("space_out", np.asarray([t[1] for t in tuples])),
        "longitude_out": Coord("space_out", np.asarray([t[2] for t in tuples])),
        "original_variable_out": Coord(
            "space_out", truth_flat.coords["original_variable"].values
        ),
    }
    truth = Field(
        _host(truth_flat.data)[0],
        ("space_out", "time_holdout"),
        {**coords, "time_holdout": Coord("time_holdout", truth_flat.coords["time"].values)},
        name="holdout_truth",
    )
    persistence = Field(
        _host(persist_flat.data)[0][:, 0],
        ("space_out",),
        coords,
        name="holdout_persistence",
    )
    return {"holdout_truth": truth, "holdout_persistence": persistence}


def _tile_field_along_space(field: Field, d: int) -> Field:
    """Repeat a (space,) field d times along space: the mean/std tiling
    that matches the delay-embedded row layout."""
    data = np.tile(np.asarray(field.data), d)
    coords = {
        "space": Coord("space", np.tile(field.coords["space"].values, d)),
        "original_variable": Coord(
            "space", np.tile(field.coords["original_variable"].values, d)
        ),
    }
    return Field(data, ("space",), coords, dict(field.attrs), field.name)


def _on_device(fs: FieldSet, device: torch.device) -> FieldSet:
    """The FieldSet with each field's data a tensor on ``device``: host
    arrays copied there once, tensors already there kept as they are."""

    def move(field: Field) -> Field:
        data = field.data
        if not isinstance(data, torch.Tensor):
            arr = np.asarray(data)
            data = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        return field.copy(data=data.to(device))

    return fs.map(move)


def _preprocess_on_device(ds: FieldSet, parsed_config: dict, device: torch.device):
    """The training fields flattened to one (S, T) tensor on ``device``
    and standardized there in place, in the slice's dtype.  Returns the
    flat Field and the host (S,) X_mean and X_std Fields (None when not
    asked for), tiled to the embedded rows."""
    da_flat = flatten_era5_variables(_on_device(ds, device))
    da_mean = da_std = None
    if parsed_config["mean_center"]:
        _, mean, std = standardize_rows(da_flat.data, scale=parsed_config["scale"], inplace=True)
        d = parsed_config["delay_embedding"]
        row_coords = {name: da_flat.coords[name] for name in ("space", "original_variable")}

        def row_field(values: torch.Tensor, name: str) -> Field:
            field = Field(values.cpu().numpy(), ("space",), row_coords, dict(da_flat.attrs), "X")
            if d > 1:
                field = _tile_field_along_space(field, d)
            field.name = name
            return field

        da_mean = row_field(mean, "X_mean")
        if std is not None:
            da_std = row_field(std, "X_std")
    return da_flat, da_mean, da_std


def compute_svd_results(
    ds: FieldSet,
    parsed_config: dict,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
) -> FieldSet:
    """The stage's compute body on an ERA5 slice: select the variables,
    slice the levels, resample, withhold the forecast holdout, flatten
    and standardize on ``device``, ``svd_on_era5``, package the factors
    (host arrays) with X_mean / X_std, the holdout truth and (with
    ``save_data_matrix``) the embedded X, stamp the config attributes
    and metrics, and split the space coordinate for HDF5.

    ``device``: the card unless given, or unless the slice's fields hold
    tensors on another device; ``mesh``: the SVD's (its device then the
    stage's), default ``parallel.mesh_from_config`` over the world.
    """
    ds = ds[parsed_config["variables"]]
    ds = slice_era5_dataset(ds, levels=parsed_config["levels"])
    ds = resample_era5_dataset(ds, parsed_config["delta_time"])
    device = mesh.device if mesh is not None else _device(device, ds.first())

    # ---- forecast holdout: withhold the trailing snapshots from
    # everything downstream (standardization statistics, factors) so the
    # DMD stage can score its rollout against unseen truth.  The raw
    # holdout fields and the last raw train snapshot (the persistence
    # baseline) ride along in the artifact.
    holdout = int(parsed_config.get("forecast_holdout", 0))
    ds_holdout = persist_raw = None
    if holdout > 0:
        n_time = len(ds.coord("time").values)
        d_embed = parsed_config["delay_embedding"]
        min_train = max(parsed_config["n_components"] + d_embed, d_embed + 1)
        if n_time - holdout < min_train:
            raise ValueError(
                f"forecast_holdout={holdout} leaves {n_time - holdout} train snapshots "
                f"of {n_time}; need >= {min_train} (n_components + delay)."
            )
        ds_holdout = ds.isel(time=slice(n_time - holdout, None))
        persist_raw = ds.isel(time=slice(n_time - holdout - 1, n_time - holdout))
        ds = ds.isel(time=slice(0, n_time - holdout))
        log_and_print(
            _logger(),
            f"Withholding final {holdout} snapshots from the fit "
            f"({n_time - holdout} train columns remain).",
        )

    da_flat, da_mean, da_std = _preprocess_on_device(ds, parsed_config, device)
    d = parsed_config["delay_embedding"]
    U, s, V = svd_on_era5(None, parsed_config, device=device, da_flat=da_flat, mesh=mesh)
    embedded_coords = delay_embedded_coords(da_flat, d)
    da = None
    if parsed_config["save_data_matrix"]:
        host_flat = da_flat.copy(data=da_flat.data.cpu().numpy())
        da = apply_delay_embedding(host_flat, d)
    del da_flat

    svd_results = combine_svd_results(U, s, V, embedded_coords, X=da, X_mean=da_mean, X_std=da_std)
    if ds_holdout is not None:
        svd_results.data_vars.update(_holdout_truth_fields(ds_holdout, persist_raw))
    svd_results = add_config_attributes(svd_results, parsed_config)
    svd_results.attrs.update(parsed_config.get("metrics", {}))
    return space_coord_to_level_lat_lon(svd_results)


def _write_results(results: FieldSet, parsed_config: dict, use_store: bool, logger,
                   kind: str = "SVD") -> bool:
    """A stage's artifact (``kind``: SVD or DMD results) written and (with
    ``use_store``) versioned; True when it was added to the store."""
    try:
        log_and_print(logger, f"Writing {kind} results...")
        save_fieldset(results, parsed_config["save_path"])
        log_and_print(logger, f"{kind} results written to {parsed_config['save_path']}")
    except Exception as err:
        msg = f"Error writing {kind} results: {err}"
        log_and_print(logger, msg, "error")
        raise Exception(msg) from err
    if not use_store:
        return False
    try:
        log_and_print(logger, f"Versioning {kind} results...")
        add_data_to_store(parsed_config["save_path"], results.attrs)
        log_and_print(logger, f"{kind} results versioned.")
    except Exception as err:
        msg = f"Error versioning {kind} results: {err}"
        log_and_print(logger, msg, "error")
        raise Exception(msg) from err
    return True


def main(
    config: dict | None = None,
    write_artifact: bool = False,
    use_store: bool = False,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
) -> tuple[FieldSet, bool, bool]:
    """SVD stage orchestration: the cached results if the workdir or the
    store holds a match, else :func:`compute_svd_results` on the slice
    from the workdir or the store, then (with ``write_artifact``) the
    artifact written and (with ``use_store``) versioned, by rank 0 alone
    in a world of several ranks (the others wait for it, and raise with
    it if it fails).

    Returns (svd_results, added_to_store, retrieved_from_store).
    ``device``: where a computation runs, the card unless given;
    ``mesh``: the stage mesh (default: ``mesh_shape`` and
    ``dcn_mesh_shape`` over the world, ``parallel.mesh_from_config``).
    Every rank of the world calls it.
    """
    if config is None:
        config = config_reader("era5-svd")
    logger = _logger()
    added_to_store = False
    parsed_config = config_parser(config, "era5-svd")

    try:
        svd_results, retrieved_from_store = retrieve_svd_results(parsed_config, use_store)
    except Exception as err:
        msg = f"Error retrieving SVD results: {err}"
        log_and_print(logger, msg, "error")
        raise Exception(msg) from err

    if svd_results is None:
        try:
            ds, _ = retrieve_era5_slice(parsed_config, use_store)
            if ds is None:
                if use_store:
                    msg = "Could not retrieve ERA5 slice from working directory or store."
                else:
                    msg = (
                        "Could not retrieve ERA5 slice from working directory. "
                        "Consider using the artifact store, if available."
                    )
                log_and_print(logger, msg, "error")
                raise FileNotFoundError(msg)
        except Exception as err:
            msg = f"Error retrieving ERA5 slice: {err}"
            log_and_print(logger, msg, "error")
            raise Exception(msg) from err

        try:
            svd_results = compute_svd_results(ds, parsed_config, device=device, mesh=mesh)
        except Exception as err:
            msg = f"Error in the SVD on ERA5 process: {err}"
            log_and_print(logger, msg, "error")
            raise Exception(msg) from err

        if write_artifact:
            added_to_store = bool(_on_rank0(
                lambda: _write_results(svd_results, parsed_config, use_store, logger)))

    return svd_results, added_to_store, retrieved_from_store


if __name__ == "__main__":
    main(write_artifact=True, use_store=True)
