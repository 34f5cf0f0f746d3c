"""Numerical-safety and determinism checks.

PyTorch counterpart of ``dmd_era5_tpu/utils/debug.py``: NaN trapping
(:func:`debug_nans`, a ``TorchDispatchMode`` in place of the
``jax_debug_nans`` flag), finiteness assertions and a checksum over
nested tuples, lists and dicts of tensors or arrays, and a determinism
harness that reruns a function and compares its outputs bit for bit.

``enable_float64`` is not ported: JAX computes in f32 unless told
otherwise, while torch takes float64 wherever a tensor is float64.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["debug_nans", "assert_finite", "tree_checksum", "check_deterministic"]


class _NanTrap(TorchDispatchMode):
    """Raise at the first op whose floating or complex output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_leaves(out):
            if (isinstance(leaf, torch.Tensor) and (leaf.is_floating_point() or leaf.is_complex())
                    and bool(torch.isnan(leaf).any())):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Trap NaN production by any torch op inside the scope."""
    if not enable:
        yield
        return
    with _NanTrap():
        yield


def _leaves(tree, path: str = "") -> Iterator[tuple[str, object]]:
    """(path, leaf) of a nested tuple/list/dict, dict keys sorted as JAX
    flattens them."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def assert_finite(tree, name: str = "value") -> None:
    """Raise if any leaf of a nested structure contains NaN/Inf."""
    for path, leaf in _leaves(tree):
        arr = _host(leaf)
        if not np.all(np.isfinite(arr)):
            n_bad = int(np.size(arr) - np.sum(np.isfinite(arr)))
            raise FloatingPointError(
                f"{name}{path} has {n_bad} non-finite values (shape {arr.shape})"
            )


def tree_checksum(tree) -> float:
    """Deterministic scalar digest of a nested structure of arrays."""
    total = 0.0
    for _, leaf in _leaves(tree):
        arr = _host(leaf)
        arr = np.abs(arr) if np.iscomplexobj(arr) else arr
        arr = arr.astype(np.float64)
        total += float(np.sum(arr * np.arange(1, arr.size + 1).reshape(arr.shape) % 97))
    return total


def check_deterministic(fn: Callable, *args, runs: int = 2) -> bool:
    """Run fn repeatedly and require bit-identical outputs (NaNs equal)."""
    outs = [[_host(leaf) for _, leaf in _leaves(fn(*args))] for _ in range(runs)]
    first = outs[0]
    return all(
        len(other) == len(first)
        and all(np.array_equal(a, b, equal_nan=True) for a, b in zip(first, other))
        for other in outs[1:]
    )
