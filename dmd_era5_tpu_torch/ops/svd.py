"""Truncated-SVD result type and the sklearn conventions it follows.

The part of ``dmd_era5_tpu/ops/svd.py`` that the randomized Hankel path
uses: the result container, sklearn's v-based sign flip and its
``n_iter='auto'`` rule.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SVDResult", "sklearn_n_iter"]


class SVDResult(NamedTuple):
    """U (S, k), s (k,) and V (k, T) with rows as components."""

    U: torch.Tensor
    s: torch.Tensor
    V: torch.Tensor


def _svd_flip_v_based(U: torch.Tensor, V: torch.Tensor):
    """Deterministic signs via the max-|.| entry of each right singular
    vector (sklearn's ``svd_flip(u_based_decision=False)``).

    Scales U IN PLACE (it is S-sized; a copy would double the basis's
    memory) and returns (U, flipped copy of V).
    """
    max_idx = torch.argmax(V.abs(), dim=1)
    signs = torch.sign(V[torch.arange(V.shape[0], device=V.device), max_idx])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return U.mul_(signs[None, :]), V * signs[:, None]


def sklearn_n_iter(n_components: int, shape: tuple[int, int]) -> int:
    """sklearn's n_iter='auto' rule: 7 if k < 0.1 * min(shape) else 4."""
    return 7 if n_components < 0.1 * min(shape) else 4
