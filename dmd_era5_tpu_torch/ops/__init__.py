"""Operators over the snapshot matrix: the fused kernel pass and its
two-pass fallback, the Hankel operators, the tiled
matmul (``ops.matmul.matmul``; not re-exported here, where its name
would hide the module), the Gram kernel, the Householder panel,
tall-skinny QR and the SVDs on them (on one device or a mesh), the one-pass (two-sided sketch)
SVD, the streaming sketch and the rank update."""

from dmd_era5_tpu_torch.ops.hankel import (
    delay_embed_time_sharded,
    hankel_exact_svd,
    hankel_project,
    hankel_randomized_svd,
    hankel_randomized_svd_2d,
    hankel_randomized_svd_fused,
    hankel_randomized_svd_fused_core,
    hankel_randomized_svd_sharded,
    hankel_sketch,
    hankel_sketch_time_sharded,
    stacked_sketch_matrix,
)
from dmd_era5_tpu_torch.ops.matmul import project, sketch_center_gram, sketch_center_gram_project
from dmd_era5_tpu_torch.ops.onepass import (
    OnePassSketch,
    onepass_core,
    onepass_finalize,
    onepass_svd,
    psi_panel,
)
from dmd_era5_tpu_torch.ops.qr_panel import cholqr, cholqr2, cholqr2_split, gram, householder_panel
from dmd_era5_tpu_torch.ops.svd import (
    SVDResult,
    exact_truncated_svd,
    exact_truncated_svd_gram,
    randomized_svd,
    randomized_svd_2d,
    sklearn_n_iter,
    truncated_svd,
)
from dmd_era5_tpu_torch.ops.streaming import StreamingSketch, svd_rank_update
from dmd_era5_tpu_torch.ops.tsqr import default_qr_method, qr_positive, tsqr

__all__ = [
    "OnePassSketch",
    "SVDResult",
    "StreamingSketch",
    "cholqr",
    "cholqr2",
    "cholqr2_split",
    "default_qr_method",
    "delay_embed_time_sharded",
    "exact_truncated_svd",
    "exact_truncated_svd_gram",
    "gram",
    "hankel_exact_svd",
    "hankel_project",
    "hankel_randomized_svd",
    "hankel_randomized_svd_2d",
    "hankel_randomized_svd_fused",
    "hankel_randomized_svd_fused_core",
    "hankel_randomized_svd_sharded",
    "hankel_sketch",
    "hankel_sketch_time_sharded",
    "householder_panel",
    "onepass_core",
    "onepass_finalize",
    "onepass_svd",
    "project",
    "psi_panel",
    "qr_positive",
    "randomized_svd",
    "randomized_svd_2d",
    "sketch_center_gram",
    "sketch_center_gram_project",
    "sklearn_n_iter",
    "stacked_sketch_matrix",
    "svd_rank_update",
    "truncated_svd",
    "tsqr",
]
