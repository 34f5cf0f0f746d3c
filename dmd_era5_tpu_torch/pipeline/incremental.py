"""Incremental SVD artifacts: extend a decomposition with new snapshots.

PyTorch counterpart of ``dmd_era5_tpu/pipeline/incremental.py``
(north-star config 5 of ``BASELINE.json``: a streaming/updating rank-k
SVD with versioned incremental snapshots).  Given an existing SVD
artifact and a new ERA5 slice that extends its time range, the
factorization is updated with ``ops.streaming.svd_rank_update`` (the
history is never refactored) on the card.

The new columns are standardized with the original window's statistics
(the artifact's X_mean / X_std), so the updated factors decompose the
matrix the original window defined, and delay-embedded within the new
slice: the d-1 windows that straddle the boundary are skipped unless
the slice overlaps the old window by d-1 snapshots
(``era5_svd_update.select_new_snapshots`` adds them).
"""

from __future__ import annotations

import functools
from datetime import datetime

import numpy as np
import torch

from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.ops.streaming import svd_rank_update
from dmd_era5_tpu_torch.ops.svd import SVDResult
from dmd_era5_tpu_torch.snapmat.transform import flat_data
from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet
from dmd_era5_tpu_torch.utils.tensors import as_tensor, home_device

__all__ = ["update_svd_results"]


@functools.cache
def _logger():
    return setup_logger("ERA5-SVD-Update-torch", "era5_svd_update_torch.log")


def update_svd_results(
    svd_results: FieldSet,
    new_slice: FieldSet,
    n_components: int | None = None,
    device: torch.device | str | None = None,
) -> FieldSet:
    """Append a new time slice to an existing SVD results FieldSet.

    Counterpart of ``dmd_era5_tpu/pipeline/incremental.py:35``.
    ``svd_results``: the artifact (its variables and levels the slice's;
    produced by ``pipeline.era5_svd``).  ``new_slice``: an ERA5 FieldSet
    whose time range extends the artifact's, its fields host arrays or
    tensors.  ``n_components``: rank of the update (default: keep).
    ``device``: where the update runs, the card unless given; a host
    artifact's factors move there once.

    Returns a new FieldSet with U, s and V as host (numpy) arrays, the
    time coordinate extended and the attrs refreshed.
    """
    device = home_device(None, device)
    attrs = svd_results.attrs
    d = int(attrs["delay_embedding"])
    variables = attrs["variables"] if isinstance(attrs["variables"], list) else [attrs["variables"]]

    # the new columns, standardized with the original window's statistics
    # and delay-embedded, on the device
    x_new = as_tensor(flat_data(new_slice[variables]), torch.float32, device)  # (S, T_new)
    s_rows = x_new.shape[0]
    for name, op in (("X_mean", torch.Tensor.sub_), ("X_std", torch.Tensor.div_)):
        if name in svd_results:
            stat = as_tensor(svd_results[name].data, torch.float32, device)[:s_rows]
            op(x_new, stat[:, None])
    t_out = x_new.shape[1] - d + 1
    if t_out < 1:
        raise ValueError("Delay embedding longer than the new slice.")
    emb = x_new if d == 1 else torch.cat([x_new[:, j:j + t_out] for j in range(d)], dim=0)
    del x_new

    old = SVDResult(*(as_tensor(svd_results[name].data, torch.float32, device)
                      for name in ("U", "s", "V")))
    log_and_print(_logger(), f"Updating rank-{old.s.shape[0]} SVD with {emb.shape[1]} new "
                             f"columns on {device}...")
    updated = svd_rank_update(old, emb, n_components=n_components)
    del old, emb
    u, s, v = (a.cpu().numpy() for a in updated)
    del updated

    old_times = np.asarray(svd_results["V"].coords["time"].values)
    new_times = np.asarray(new_slice.coord("time").values)[d - 1:]
    times_all = np.concatenate([old_times, new_times])

    k = s.shape[0]
    components = Coord("components", np.arange(k))
    u_field = svd_results["U"]
    data_vars: dict[str, Field] = {
        "U": Field(u, ("space", "components"),
                   {**{n: c for n, c in u_field.coords.items() if n != "components"},
                    "components": components}, name="U"),
        "s": Field(s, ("components",), {"components": components}, name="s"),
        "V": Field(v, ("components", "time"),
                   {"components": components, "time": Coord("time", times_all)}, name="V"),
    }
    for extra in ("X_mean", "X_std"):
        if extra in svd_results:
            data_vars[extra] = svd_results[extra]

    out = FieldSet(data_vars, attrs=dict(attrs))
    out.attrs["n_components"] = int(k)
    out.attrs["updated_through"] = str(np.asarray(new_times[-1] if len(new_times)
                                                  else old_times[-1]))
    out.attrs["date_processed"] = datetime.now().isoformat()
    return out
