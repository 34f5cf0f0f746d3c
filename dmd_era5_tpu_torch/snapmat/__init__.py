"""Snapshot-matrix preprocessing."""

from dmd_era5_tpu_torch.snapmat.transform import standardize_data

__all__ = ["standardize_data"]
