"""Labeled containers, small-matrix linear algebra and input conversion."""

from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet
from dmd_era5_tpu_torch.utils.linalg import (
    complex_lstsq,
    complex_solve,
    eig_sorted,
    gram_whiten,
    orth_small,
    safe_cholesky,
    spd_solve,
)
from dmd_era5_tpu_torch.utils.tensors import as_tensor

__all__ = [
    "Coord",
    "Field",
    "FieldSet",
    "as_tensor",
    "complex_lstsq",
    "complex_solve",
    "eig_sorted",
    "gram_whiten",
    "orth_small",
    "safe_cholesky",
    "spd_solve",
]
