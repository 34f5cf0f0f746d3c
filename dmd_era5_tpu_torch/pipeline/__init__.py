"""The fused fit step, the out-of-core (streamed) SVD and the SVD stage."""

from dmd_era5_tpu_torch.pipeline.era5_svd import (
    combine_svd_results,
    resolve_svd_backend,
    svd_on_era5,
)
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
    fit_step_lean,
)

__all__ = [
    "FitState",
    "combine_svd_results",
    "fit_ingest_pass",
    "fit_reduce_lift",
    "fit_step_fused",
    "fit_step_lean",
    "prefetched_row_blocks",
    "resolve_svd_backend",
    "streamed_exact_gram_svd",
    "streamed_randomized_svd",
    "streamed_randomized_svd_core",
    "svd_on_era5",
]
