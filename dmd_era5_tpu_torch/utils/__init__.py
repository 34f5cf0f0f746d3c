"""Labeled containers, small-matrix linear algebra, input conversion and
staging, profiling and numerical-safety checks."""

from dmd_era5_tpu_torch.utils.debug import (
    assert_finite,
    check_deterministic,
    debug_nans,
    tree_checksum,
)
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
from dmd_era5_tpu_torch.utils.profiling import (
    DevicePeaks,
    device_peaks,
    measure,
    roofline,
    throughput,
    trace,
)
from dmd_era5_tpu_torch.utils.tensors import CopyRing, as_tensor

__all__ = [
    "Coord",
    "CopyRing",
    "DevicePeaks",
    "Field",
    "FieldSet",
    "as_tensor",
    "assert_finite",
    "check_deterministic",
    "complex_lstsq",
    "complex_solve",
    "debug_nans",
    "device_peaks",
    "eig_sorted",
    "gram_whiten",
    "measure",
    "orth_small",
    "roofline",
    "safe_cholesky",
    "spd_solve",
    "throughput",
    "trace",
    "tree_checksum",
]
