"""The snapshot packer, in torch on the host.

The port's counterpart of ``dmd_era5_tpu/native/__init__.py`` and its
C++ ``packer.cpp``: ERA5 fields arrive time-major (time, level, lat,
lon) from the storage layer, while the decomposition consumes a
space-major (space, time) snapshot matrix.  There is one implementation
and no build: a transposed ``Tensor.copy_`` on the CPU is torch's own
threaded copy, and its f32 -> bf16 conversion rounds to nearest even as
the packer's ``f32_to_bf16_rne`` does (``packer.cpp:26-31``).

bf16 words agree with the packer's bit for bit on every finite value
and on the canonical quiet NaN (0x7FC00000, the fill of a missing
chunk).  Every other NaN becomes that canonical NaN's word 0x7FC0 here,
whereas the packer's integer rounding carries a NaN's payload into the
exponent: a NaN with low payload bits set comes out of it as an
infinity or a wrapped word, and a negative NaN keeps its sign.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pack_space_time", "row_stats", "to_bf16_words", "bf16_words_of"]

_BF16_NAN = 0x7FC0  # the canonical quiet NaN's upper half
_STATS_ROWS = 1 << 16  # rows summed in f64 at a time by row_stats


def bf16_words_of(src: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """src (float32, any device or layout) rounded to bf16 words, int16.

    ``out``: a contiguous bfloat16 tensor of src's shape to round into (a
    new one by default); its int16 view is returned.  Every NaN gives the
    canonical word 0x7FC0: torch's vectorized conversion would give
    0xFFFF."""
    if out is None:
        out = torch.empty(src.shape, dtype=torch.bfloat16, device=src.device)
    out.copy_(src)
    words = out.view(torch.int16)
    words.masked_fill_(torch.isnan(out), _BF16_NAN)
    return words


def _as_f32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def pack_space_time(snapshots: np.ndarray, bf16: bool = False) -> np.ndarray:
    """(T, n_space) time-major -> (n_space, T) space-major snapshot matrix.

    With ``bf16=True`` the output is bfloat16 stored as uint16 words,
    rounded and transposed in one copy."""
    src = _as_f32(snapshots)
    if src.ndim != 2:
        raise ValueError(f"pack_space_time expects a 2-D (time, space) array, got {src.ndim}-D")
    n_time, n_space = src.shape
    if bf16:
        out = torch.empty((n_space, n_time), dtype=torch.bfloat16)
        return bf16_words_of(src.T, out).numpy().view(np.uint16)
    out = torch.empty((n_space, n_time), dtype=torch.float32)
    out.copy_(src.T)
    return out.numpy()


def row_stats(x: np.ndarray, ddof: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (mean, std) of a (rows, cols) float32 matrix, float32.

    As the packer's ``row_stats_f32``: one pass of f64 sums of x and x^2
    a row, var = (sum x^2 - n mean^2) / (n - ddof), clamped at 0, and 0
    where n - ddof <= 0."""
    xt = _as_f32(x)
    rows, cols = xt.shape
    mean = torch.empty(rows, dtype=torch.float32)
    std = torch.empty(rows, dtype=torch.float32)
    denom = cols - ddof
    for r0 in range(0, rows, _STATS_ROWS):
        block = xt[r0 : r0 + _STATS_ROWS].double()
        mu = block.sum(dim=1) / cols
        if denom > 0:
            var = ((block * block).sum(dim=1) - cols * mu * mu) / denom
            var.clamp_(min=0.0)
        else:
            var = torch.zeros_like(mu)
        mean[r0 : r0 + _STATS_ROWS] = mu
        std[r0 : r0 + _STATS_ROWS] = var.sqrt()
    return mean.numpy(), std.numpy()


def to_bf16_words(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 (round to nearest even) as uint16 words, x's shape."""
    return bf16_words_of(_as_f32(x)).numpy().view(np.uint16)
