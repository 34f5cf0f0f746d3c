"""Small-matrix linear algebra."""

from dmd_era5_tpu_torch.utils.linalg import (
    complex_lstsq,
    complex_solve,
    eig_sorted,
    gram_whiten,
    orth_small,
    safe_cholesky,
    spd_solve,
)

__all__ = [
    "complex_lstsq",
    "complex_solve",
    "eig_sorted",
    "gram_whiten",
    "orth_small",
    "safe_cholesky",
    "spd_solve",
]
