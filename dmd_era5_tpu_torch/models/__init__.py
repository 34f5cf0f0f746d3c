"""DMD models: exact DMD, optimized DMD (single, batched, checkpointed),
BOP-DMD, mrDMD, DMDc, the forecast rollout, its verification scores and
the spectral analysis of a fit."""

from dmd_era5_tpu_torch.models.analysis import ModeSpectrum, mode_spectrum, modes_to_grid
from dmd_era5_tpu_torch.models.bopdmd import BOPDMDResult, bopdmd_from_svd, fit_bopdmd
from dmd_era5_tpu_torch.models.dmd import DMDResult, dmd_from_svd, exact_dmd, reconstruct
from dmd_era5_tpu_torch.models.dmdc import DMDcResult, dmdc_from_svd, dmdc_rollout, fit_dmdc
from dmd_era5_tpu_torch.models.forecast import (
    forecast_times,
    iter_forecast_blocks,
    rollout,
    streamed_forecast_scores,
    undo_preprocessing,
)
from dmd_era5_tpu_torch.models.mrdmd import (
    MrDMDLevel,
    MrDMDResult,
    fit_mrdmd,
    fit_mrdmd_gram,
    fit_mrdmd_streamed,
    mrdmd_from_svd,
    mrdmd_reconstruct,
)
from dmd_era5_tpu_torch.models.optdmd import (
    BatchedOptDMDResult,
    OptDMDResult,
    fit_optdmd,
    optdmd_from_svd,
    optdmd_from_svd_batched,
    optdmd_reconstruct,
    varpro_lm,
    varpro_lm_batched,
    varpro_lm_checkpointed,
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
    "BatchedOptDMDResult",
    "DMDResult",
    "DMDcResult",
    "ModeSpectrum",
    "MrDMDLevel",
    "MrDMDResult",
    "OptDMDResult",
    "ScoreAccumulator",
    "bopdmd_from_svd",
    "dmd_from_svd",
    "dmdc_from_svd",
    "dmdc_rollout",
    "exact_dmd",
    "fit_bopdmd",
    "fit_dmdc",
    "fit_mrdmd",
    "fit_mrdmd_gram",
    "fit_mrdmd_streamed",
    "fit_optdmd",
    "forecast_scores",
    "forecast_times",
    "iter_forecast_blocks",
    "latitude_weights",
    "mode_spectrum",
    "modes_to_grid",
    "mrdmd_from_svd",
    "mrdmd_reconstruct",
    "optdmd_from_svd",
    "optdmd_from_svd_batched",
    "optdmd_reconstruct",
    "reconstruct",
    "rollout",
    "streamed_forecast_scores",
    "undo_preprocessing",
    "varpro_lm",
    "varpro_lm_batched",
    "varpro_lm_checkpointed",
    "weighted_acc",
    "weighted_bias",
    "weighted_rmse",
]
