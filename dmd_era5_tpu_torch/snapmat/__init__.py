"""Snapshot-matrix preprocessing and the packed artifact."""

from dmd_era5_tpu_torch.snapmat.loader import packed_info, read_packed_rows, save_packed_matrix
from dmd_era5_tpu_torch.snapmat.transform import (
    apply_delay_embedding,
    delay_embed_np,
    delay_embedded_coords,
    flatten_era5_variables,
    standardize_data,
)

__all__ = [
    "apply_delay_embedding",
    "delay_embed_np",
    "delay_embedded_coords",
    "flatten_era5_variables",
    "packed_info",
    "read_packed_rows",
    "save_packed_matrix",
    "standardize_data",
]
