"""DMD models: exact DMD, optimized DMD and the forecast rollout."""

from dmd_era5_tpu_torch.models.dmd import DMDResult, dmd_from_svd
from dmd_era5_tpu_torch.models.forecast import forecast_times, rollout, undo_preprocessing
from dmd_era5_tpu_torch.models.optdmd import OptDMDResult, optdmd_from_svd, varpro_lm

__all__ = [
    "DMDResult",
    "OptDMDResult",
    "dmd_from_svd",
    "forecast_times",
    "optdmd_from_svd",
    "rollout",
    "undo_preprocessing",
    "varpro_lm",
]
