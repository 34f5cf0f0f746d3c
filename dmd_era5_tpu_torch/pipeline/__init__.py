"""The fused fit step and the out-of-core (streamed) SVD."""

from dmd_era5_tpu_torch.pipeline.streamed_fit import (
    prefetched_row_blocks,
    streamed_exact_gram_svd,
    streamed_randomized_svd,
    streamed_randomized_svd_core,
)
from dmd_era5_tpu_torch.pipeline.train_step import (
    FitState,
    fit_ingest_pass,
    fit_reduce_lift,
    fit_step_fused,
)

__all__ = [
    "FitState",
    "fit_ingest_pass",
    "fit_reduce_lift",
    "fit_step_fused",
    "prefetched_row_blocks",
    "streamed_exact_gram_svd",
    "streamed_randomized_svd",
    "streamed_randomized_svd_core",
]
