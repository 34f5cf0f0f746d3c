"""Snapshot-matrix preprocessing: slicing, transforms, mock data, the Zarr
ingest and the packed artifact."""

from dmd_era5_tpu_torch.snapmat.era5_zarr import read_era5_zarr_slice, zarr_to_packed
from dmd_era5_tpu_torch.snapmat.loader import (
    SnapshotMeta,
    build_snapshot_matrix,
    host_row_stats,
    load_row_sharded,
    packed_info,
    read_packed_rows,
    save_packed_matrix,
    save_packed_snapshot,
)
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
from dmd_era5_tpu_torch.snapmat.zarr_reader import open_zarr_group

__all__ = [
    "SnapshotMeta",
    "apply_delay_embedding",
    "build_snapshot_matrix",
    "create_mock_era5",
    "create_mock_era5_svd",
    "dataset_time_bounds",
    "delay_embed_np",
    "delay_embedded_coords",
    "flatten_era5_variables",
    "host_row_stats",
    "load_row_sharded",
    "open_zarr_group",
    "packed_info",
    "read_era5_zarr_slice",
    "read_packed_rows",
    "resample_era5_dataset",
    "save_packed_matrix",
    "save_packed_snapshot",
    "slice_era5_dataset",
    "space_coord_to_level_lat_lon",
    "standardize_data",
    "standardize_rows",
    "zarr_to_packed",
]
