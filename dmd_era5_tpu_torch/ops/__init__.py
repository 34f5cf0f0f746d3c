"""Operators over the snapshot matrix: the fused kernel pass and the SVDs on it."""

from dmd_era5_tpu_torch.ops.hankel import (
    hankel_randomized_svd_fused,
    hankel_randomized_svd_fused_core,
    stacked_sketch_matrix,
)
from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project
from dmd_era5_tpu_torch.ops.svd import SVDResult, sklearn_n_iter

__all__ = [
    "SVDResult",
    "hankel_randomized_svd_fused",
    "hankel_randomized_svd_fused_core",
    "sketch_center_gram_project",
    "sklearn_n_iter",
    "stacked_sketch_matrix",
]
