"""The fused fit step."""

from dmd_era5_tpu_torch.pipeline.train_step import (
    FitState,
    fit_ingest_pass,
    fit_reduce_lift,
    fit_step_fused,
)

__all__ = ["FitState", "fit_ingest_pass", "fit_reduce_lift", "fit_step_fused"]
