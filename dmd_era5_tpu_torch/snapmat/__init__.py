"""Snapshot-matrix preprocessing: slicing, transforms, mock data and the
packed artifact."""

from dmd_era5_tpu_torch.snapmat.loader import packed_info, read_packed_rows, save_packed_matrix
from dmd_era5_tpu_torch.snapmat.mock import create_mock_era5, create_mock_era5_svd
from dmd_era5_tpu_torch.snapmat.slicing import (
    dataset_time_bounds,
    resample_era5_dataset,
    slice_era5_dataset,
)
from dmd_era5_tpu_torch.snapmat.transform import (
    apply_delay_embedding,
    delay_embed_np,
    delay_embedded_coords,
    flatten_era5_variables,
    space_coord_to_level_lat_lon,
    standardize_data,
    standardize_rows,
)

__all__ = [
    "apply_delay_embedding",
    "create_mock_era5",
    "create_mock_era5_svd",
    "dataset_time_bounds",
    "delay_embed_np",
    "delay_embedded_coords",
    "flatten_era5_variables",
    "packed_info",
    "read_packed_rows",
    "resample_era5_dataset",
    "save_packed_matrix",
    "slice_era5_dataset",
    "space_coord_to_level_lat_lon",
    "standardize_data",
    "standardize_rows",
]
