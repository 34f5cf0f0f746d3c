"""Inputs as tensors: the models take tensors or host arrays alike."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_tensor", "home_device"]


def as_tensor(a, dtype: torch.dtype, device: torch.device | str | None = None) -> torch.Tensor:
    """``a`` (a tensor or an array) as a ``dtype`` tensor on ``device``:
    by default where a tensor lies, else on the host.  A tensor already
    there in ``dtype`` is returned as it is; a writable host array is
    wrapped, not copied, before the move (a read-only one is copied,
    since torch wraps only writable arrays)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=dtype)
    arr = np.asarray(a)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy()).to(device, dtype)


def home_device(a, device: torch.device | str | None = None) -> torch.device:
    """Where a computation on ``a`` runs: ``device`` when given, else
    where the tensor ``a`` lies, else (a host array) the card, which
    must then be present."""
    if device is not None:
        return torch.device(device)
    if isinstance(a, torch.Tensor):
        return a.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "this runs on a CUDA card and none is available; pass device='cpu' "
            "(or CPU tensors) to run it on the host"
        )
    return torch.device("cuda")
