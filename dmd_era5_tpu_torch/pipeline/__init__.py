"""The ingest, SVD and DMD stages, the artifact store, the fused fit step,
the per-variable ensemble, the out-of-core (streamed and one-pass) SVD
and the incremental update of an SVD artifact."""

from dmd_era5_tpu_torch.pipeline.artifacts import (
    add_data_to_dvc,
    add_data_to_store,
    file_md5,
    retrieve_data_from_dvc,
    retrieve_data_from_store,
)
from dmd_era5_tpu_torch.pipeline.era5_dmd import (
    check_dmd_results,
    fit_dmd_from_svd_results,
    retrieve_dmd_results,
)
from dmd_era5_tpu_torch.pipeline.era5_download import download_era5_data
from dmd_era5_tpu_torch.pipeline.ensemble import EnsembleFit, fit_per_variable_level
from dmd_era5_tpu_torch.pipeline.era5_svd import (
    combine_svd_results,
    compute_svd_results,
    resolve_svd_backend,
    retrieve_era5_slice,
    retrieve_svd_results,
    svd_on_era5,
)
from dmd_era5_tpu_torch.pipeline.era5_svd_update import select_new_snapshots, update_from_slice
from dmd_era5_tpu_torch.pipeline.incremental import update_svd_results
from dmd_era5_tpu_torch.pipeline.streamed_fit import (
    prefetched_row_blocks,
    streamed_exact_gram_svd,
    streamed_onepass_svd,
    streamed_onepass_svd_core,
    streamed_randomized_svd,
    streamed_randomized_svd_core,
)
from dmd_era5_tpu_torch.pipeline.train_step import (
    FitState,
    example_batch,
    fit_ingest_pass,
    fit_reduce_lift,
    fit_step,
    fit_step_fused,
    fit_step_lean,
    make_fit_step,
)

__all__ = [
    "EnsembleFit",
    "FitState",
    "add_data_to_dvc",
    "add_data_to_store",
    "check_dmd_results",
    "combine_svd_results",
    "compute_svd_results",
    "download_era5_data",
    "file_md5",
    "fit_dmd_from_svd_results",
    "fit_ingest_pass",
    "fit_per_variable_level",
    "fit_reduce_lift",
    "example_batch",
    "fit_step",
    "fit_step_fused",
    "make_fit_step",
    "fit_step_lean",
    "prefetched_row_blocks",
    "resolve_svd_backend",
    "retrieve_data_from_dvc",
    "retrieve_data_from_store",
    "retrieve_dmd_results",
    "retrieve_era5_slice",
    "retrieve_svd_results",
    "select_new_snapshots",
    "streamed_exact_gram_svd",
    "streamed_onepass_svd",
    "streamed_onepass_svd_core",
    "streamed_randomized_svd",
    "streamed_randomized_svd_core",
    "svd_on_era5",
    "update_from_slice",
    "update_svd_results",
]
