"""Operators over the snapshot matrix: the fused kernel pass, the tiled
matmul (``ops.matmul.matmul``; not re-exported here, where its name
would hide the module), the Gram kernel, the Householder panel,
tall-skinny QR and the SVDs on them."""

from dmd_era5_tpu_torch.ops.hankel import (
    hankel_exact_svd,
    hankel_randomized_svd_fused,
    hankel_randomized_svd_fused_core,
    stacked_sketch_matrix,
)
from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project
from dmd_era5_tpu_torch.ops.qr_panel import cholqr, cholqr2, cholqr2_split, gram, householder_panel
from dmd_era5_tpu_torch.ops.svd import (
    SVDResult,
    exact_truncated_svd,
    exact_truncated_svd_gram,
    randomized_svd,
    sklearn_n_iter,
    truncated_svd,
)
from dmd_era5_tpu_torch.ops.tsqr import default_qr_method, qr_positive, tsqr

__all__ = [
    "SVDResult",
    "cholqr",
    "cholqr2",
    "cholqr2_split",
    "default_qr_method",
    "exact_truncated_svd",
    "exact_truncated_svd_gram",
    "gram",
    "hankel_exact_svd",
    "hankel_randomized_svd_fused",
    "hankel_randomized_svd_fused_core",
    "householder_panel",
    "qr_positive",
    "randomized_svd",
    "sketch_center_gram_project",
    "sklearn_n_iter",
    "stacked_sketch_matrix",
    "truncated_svd",
    "tsqr",
]
