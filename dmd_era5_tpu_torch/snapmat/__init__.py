"""Snapshot-matrix preprocessing and the packed artifact."""

from dmd_era5_tpu_torch.snapmat.loader import packed_info, read_packed_rows, save_packed_matrix
from dmd_era5_tpu_torch.snapmat.transform import standardize_data

__all__ = ["packed_info", "read_packed_rows", "save_packed_matrix", "standardize_data"]
