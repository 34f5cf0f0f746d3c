"""The SVD stage's dispatcher on one device.

The port's counterpart of ``dmd_era5_tpu/pipeline/era5_svd.py``:
:func:`resolve_svd_backend` (its line 214), the single-device branches
of ``_svd_backend_hankel`` (:313) and ``_svd_backend_streamed`` (:435),
the single-device ``inmem`` branch of :func:`svd_on_era5` (:540) and
:func:`combine_svd_results` (:670).  The stage's ``main`` (the cache
ladder, slicing and the artifact store) is not ported yet.

The port has no device mesh yet: the dispatcher runs on one device
and resolves as the JAX one does on a one-device mesh (space = time = 1).
A ``mesh_shape`` over more than one device, a multislice
``dcn_mesh_shape``, the ``grid2d`` backend and a multi-process group
raise ``NotImplementedError`` (ROADMAP Queue 1 item 12), as does the
``onepass`` backend (Queue 1 item 10.1).

The snapshot matrix comes in a ``Field`` whose data is a numpy array or
a tensor; a tensor on the chosen device is used where it lies, never
copied to the host.  The factors come back as host (numpy) arrays, as
the JAX function returns them.
"""

from __future__ import annotations

import functools
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.ops.hankel import hankel_exact_svd, hankel_randomized_svd_fused
from dmd_era5_tpu_torch.ops.svd import truncated_svd
from dmd_era5_tpu_torch.pipeline.streamed_fit import (
    streamed_exact_gram_svd,
    streamed_randomized_svd,
)
from dmd_era5_tpu_torch.snapmat.loader import save_packed_matrix
from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

__all__ = [
    "HBM_BUDGET_ENV",
    "combine_svd_results",
    "resolve_svd_backend",
    "svd_on_era5",
]

# The per-device memory budget of ``svd_backend = auto``, in GB, and the
# variable that overrides it: the JAX package's, whose 12 GB default was
# set for a TPU v5e.  Kept, so that auto routes every configuration the
# way the JAX package does (ROADMAP Queue 3).
HBM_BUDGET_ENV = "DMD_ERA5_TPU_HBM_BUDGET_GB"
_HBM_BUDGET_GB = 12.0
_MESH_AXES = ("data", "space", "time")
_NO_MESH = "the port has no device mesh yet (ROADMAP Queue 1 item 12)"


@functools.cache
def _logger():
    return setup_logger("ERA5-SVD-torch", "era5_svd_torch.log")


def _check_single_device(parsed_config: dict) -> None:
    """Raise unless the configuration asks for one device."""
    spec = parsed_config.get("mesh_shape", "auto")
    if spec not in (None, "auto"):
        sizes = []
        for part in str(spec).split(","):
            name, _, value = part.partition("=")
            if name.strip() not in _MESH_AXES:
                raise ValueError(f"Unknown mesh axis {name.strip()!r}; supported axes: {_MESH_AXES}")
            sizes.append(int(value))
        if math.prod(sizes) != 1:
            raise NotImplementedError(f"mesh_shape={spec!r}: {_NO_MESH}")
    if parsed_config.get("dcn_mesh_shape") not in (None, "none", ""):
        raise NotImplementedError(f"dcn_mesh_shape={parsed_config['dcn_mesh_shape']!r}: {_NO_MESH}")
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(f"a multi-process SVD stage: {_NO_MESH}")


def _over_hbm_budget(parsed_config: dict, have_flat: bool, d: int) -> bool:
    """Whether the f32 matrix and its factor arrays exceed the per-device
    budget (``dmd_era5_tpu/pipeline/era5_svd.py:253-285``, one device)."""
    n_rows = parsed_config.get("_matrix_rows")
    t_cols = parsed_config.get("_matrix_cols")
    if not (have_flat and n_rows and t_cols):
        return False
    budget = float(os.environ.get(HBM_BUDGET_ENV, _HBM_BUDGET_GB))
    k = parsed_config.get("n_components", 0) + 28
    if n_rows * d * (t_cols + 2 * k) * 4 <= budget * 1e9:
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


def resolve_svd_backend(parsed_config: dict, have_flat: bool = True) -> str:
    """Resolve ``svd_backend = auto`` against the config, on one device.

    auto picks the Hankel-operator path for delay d > 1 (both svd
    types; the embedded matrix never exists), else the out-of-core
    streamed backend past the memory budget, else inmem.  An explicit
    grid2d with d > 1 (randomized, flat matrix given) reroutes to the
    Hankel path, as in the JAX package.
    """
    backend = parsed_config.get("svd_backend", "auto")
    svd_type = parsed_config["svd_type"]
    d = int(parsed_config.get("delay_embedding", 1))
    if backend != "auto":
        if backend == "grid2d" and d > 1 and have_flat and svd_type == "randomized":
            log_and_print(
                _logger(),
                "svd_backend='grid2d' with delay_embedding > 1 routes through "
                "the Hankel-operator path (the embedded matrix never materializes).",
            )
            return "hankel"
        return backend
    if d > 1 and have_flat:
        return "hankel"
    if _over_hbm_budget(parsed_config, have_flat, d):
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
            "svd_on_era5 runs on a CUDA card and none is available; pass "
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


def _svd_backend_hankel(da_flat: Field, parsed_config: dict, device, d: int, k: int):
    """Operator-form SVD of H_d(X), the embedded matrix never built:
    ``hankel_randomized_svd_fused`` (GEMMs in the stage's precision) or,
    for ``svd_type = standard``, ``hankel_exact_svd``."""
    x = _as_tensor(da_flat.data, device)
    if parsed_config["svd_type"] != "randomized":
        return _host(*hankel_exact_svd(x, d, k))
    gemm_dtype = torch.bfloat16 if parsed_config.get("precision") == "bfloat16" else torch.float32
    return _host(*hankel_randomized_svd_fused(x, d, k, gemm_dtype=gemm_dtype))


def _svd_backend_streamed(
    da: Field | None, da_flat: Field | None, parsed_config: dict, device, d: int, k: int
):
    """Out-of-core: pack X (the d delay slabs of the flat matrix, so the
    Hankel copy never exists in host memory) into ``<save_path>.packed.
    npy``, stream it through the exact Gram route (``svd_type =
    standard``) or the randomized power schedule, and remove it."""
    packed_path = Path(str(parsed_config["save_path"]) + ".packed.npy")
    src = da_flat if da_flat is not None else da
    x = src.data if isinstance(src.data, torch.Tensor) else _as_tensor(src.data, torch.device("cpu"))
    save_packed_matrix(packed_path, x, d=d if da_flat is not None else 1)
    block_rows = int(parsed_config.get("stream_block_rows", 1 << 16))
    try:
        if parsed_config["svd_type"] == "standard":
            res = streamed_exact_gram_svd(packed_path, k, block_rows=block_rows, device=device)
        else:
            res = streamed_randomized_svd(packed_path, k, block_rows=block_rows, device=device)
    finally:
        packed_path.unlink(missing_ok=True)
    return _host(*res)


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
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Truncated SVD of the preprocessed snapshot matrix on one device.

    ``da`` is the materialized embedded matrix (may be None when
    ``da_flat``, the un-embedded (S, T) matrix, is given).  Backends:
    ``inmem`` (``truncated_svd`` of the embedded matrix), ``hankel``
    (delay operators on ``da_flat``), ``streamed`` (out-of-core).
    ``device``: the card unless given, or unless the matrix is a tensor
    on another device.  Returns host arrays (U, s, V) and records
    ``svd_backend``, ``svd_seconds`` (after the device synchronizes)
    and ``svd_gelem_per_s`` in ``parsed_config["metrics"]``.
    """
    _check_single_device(parsed_config)
    svd_type = parsed_config["svd_type"]
    n_components = parsed_config["n_components"]
    d = int(parsed_config.get("delay_embedding", 1))
    gemm_dtype = torch.bfloat16 if parsed_config.get("precision") == "bfloat16" else torch.float32
    device = _device(device, da_flat if da_flat is not None else da)
    if da_flat is not None:
        parsed_config["_matrix_rows"] = int(da_flat.data.shape[0])
        parsed_config["_matrix_cols"] = int(da_flat.data.shape[1])
    backend = resolve_svd_backend(parsed_config, have_flat=da_flat is not None)
    if backend == "grid2d":
        raise NotImplementedError(f"svd_backend='grid2d': {_NO_MESH}")
    if backend == "onepass":
        raise NotImplementedError(
            "svd_backend='onepass': streamed_onepass_svd is not ported yet "
            "(ROADMAP Queue 1 item 10.1)"
        )
    log_and_print(_logger(), f"Performing {svd_type} SVD (backend={backend}) on {device}...")

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
        u, s, v = _svd_backend_hankel(da_flat, parsed_config, device, d, n_components)
    elif backend == "streamed":
        if da is None and da_flat is None:
            raise ValueError("svd_on_era5 needs da or da_flat")
        u, s, v = _svd_backend_streamed(da, da_flat, parsed_config, device, d, n_components)
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
