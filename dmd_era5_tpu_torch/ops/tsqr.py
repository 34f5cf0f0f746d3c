"""Tall-skinny QR on one device.

PyTorch counterpart of the single-device part of
``dmd_era5_tpu/ops/tsqr.py`` (:58-107, :241-272): the positive-diagonal
QR, the local factorization leaves and their default.  The tree combine
across row shards is the distributed layer's (not ported yet), and so
are ``tsqr_orthonormalize`` and the ``mesh`` argument.  The ``"xla"``
leaf existed only for a CPU mesh under a TPU default backend and is
gone.
"""

from __future__ import annotations

import torch

from dmd_era5_tpu_torch.ops.qr_panel import cholqr2, cholqr2_split, householder_panel

__all__ = ["qr_positive", "tsqr", "default_qr_method", "QR_METHODS"]

QR_METHODS = ("householder", "cholqr2", "cholqr2_split")


def qr_positive(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR with the diag(R) >= 0 sign convention
    (``dmd_era5_tpu/ops/tsqr.py:58``)."""
    q, r = torch.linalg.qr(x, mode="reduced")
    signs = torch.sign(torch.diagonal(r))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return q * signs[None, :], r * signs[:, None]


def in_householder_kernel_envelope(m: int, n: int) -> bool:
    """Whether the JAX package would run its Pallas Householder panel
    kernel (K7) on an (m, n) panel: n <= 256 and the panel plus two
    scratch copies within 12 MiB (``dmd_era5_tpu/ops/tsqr.py:91-95``)."""
    return n <= 256 and 3 * m * n * 4 <= 12 * 1024 * 1024


def _local_factor(x: torch.Tensor, method: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Local tall-skinny factorization (``dmd_era5_tpu/ops/tsqr.py:66``).

    ``"cholqr2"`` and ``"cholqr2_split"`` run the CholeskyQR2 leaves of
    :mod:`ops.qr_panel` on the Gram kernel.  ``"householder"`` is the
    backward-stable leaf.  Off the CPU, inside the JAX package's envelope
    for its Householder panel kernel, it runs
    :func:`ops.qr_panel.householder_panel` (K7 on a CUDA tensor; any
    other device raises there); outside the envelope and on the CPU it
    takes the library QR, as the JAX package does.
    """
    if method == "cholqr2":
        return cholqr2(x)
    if method == "cholqr2_split":
        return cholqr2_split(x)
    if method != "householder":
        raise ValueError(f"qr method must be one of {QR_METHODS}, got {method!r}")
    if x.device.type != "cpu" and in_householder_kernel_envelope(*x.shape):
        return householder_panel(x)
    return qr_positive(x)


def default_qr_method(x: torch.Tensor) -> str:
    """The JAX package's accelerator default, the split-precision
    CholQR2 leaf, for a CUDA tensor; its non-TPU default, Householder
    (library QR), for any other (``dmd_era5_tpu/ops/tsqr.py:102``)."""
    return "cholqr2_split" if x.device.type == "cuda" else "householder"


def tsqr(x: torch.Tensor, method: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """QR of a tall-skinny (S, T) matrix on one device: (Q (S, T), R (T, T)).

    Counterpart of ``dmd_era5_tpu/ops/tsqr.py:241`` without a mesh: one
    local factorization by ``method`` (default :func:`default_qr_method`).
    """
    return _local_factor(x, method or default_qr_method(x))
