"""DMD models: exact DMD, optimized DMD, BOP-DMD, the forecast rollout
and its verification scores."""

from dmd_era5_tpu_torch.models.bopdmd import BOPDMDResult, bopdmd_from_svd, fit_bopdmd
from dmd_era5_tpu_torch.models.dmd import DMDResult, dmd_from_svd, exact_dmd, reconstruct
from dmd_era5_tpu_torch.models.forecast import (
    forecast_times,
    iter_forecast_blocks,
    rollout,
    streamed_forecast_scores,
    undo_preprocessing,
)
from dmd_era5_tpu_torch.models.optdmd import (
    OptDMDResult,
    fit_optdmd,
    optdmd_from_svd,
    optdmd_reconstruct,
    varpro_lm,
    varpro_lm_batched,
)
from dmd_era5_tpu_torch.models.verification import (
    ScoreAccumulator,
    forecast_scores,
    latitude_weights,
    weighted_acc,
    weighted_bias,
    weighted_rmse,
)

__all__ = [
    "BOPDMDResult",
    "DMDResult",
    "OptDMDResult",
    "ScoreAccumulator",
    "bopdmd_from_svd",
    "dmd_from_svd",
    "exact_dmd",
    "fit_bopdmd",
    "fit_optdmd",
    "forecast_scores",
    "forecast_times",
    "iter_forecast_blocks",
    "latitude_weights",
    "optdmd_from_svd",
    "optdmd_reconstruct",
    "reconstruct",
    "rollout",
    "streamed_forecast_scores",
    "undo_preprocessing",
    "varpro_lm",
    "varpro_lm_batched",
    "weighted_acc",
    "weighted_bias",
    "weighted_rmse",
]
