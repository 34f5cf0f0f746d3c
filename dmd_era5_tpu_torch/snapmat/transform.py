"""Snapshot-matrix preprocessing on tensors.

The tensor arithmetic of ``dmd_era5_tpu/snapmat/transform.py::
standardize_data``: per-row statistics along time of an (S, T) snapshot
matrix.  The ``Field``/``FieldSet`` containers are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["standardize_data"]


def standardize_data(x: torch.Tensor, scale: bool = True):
    """Mean-centre (and with ``scale`` divide by the std) each row of x.

    Returns ``(standardized, mean, std_or_None)`` with mean and std of
    shape (S,), the statistics ``models.forecast.undo_preprocessing``
    needs.  The std is the population std (ddof 0) of the centred rows.
    """
    mean = x.mean(dim=1)
    centered = x - mean[:, None]
    if not scale:
        return centered, mean, None
    std = centered.std(dim=1, correction=0)
    return centered.div_(std[:, None]), mean, std
