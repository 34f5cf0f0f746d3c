"""Pytree checkpoints in HDF5, for resumable iterative solves.

PyTorch counterpart of ``dmd_era5_tpu/utils/checkpoint.py``, in its
layout: one dataset ``leaf_<i>`` per leaf in flatten order, and the file
attributes ``treedef`` (the tree's structure as JAX prints it),
``n_leaves`` and ``metadata`` (JSON), so a checkpoint written by either
package loads in the other.  A tree is nested tuples, lists and dicts
(keys in sorted order, as JAX flattens them) of leaves: tensors (copied
from their device), arrays or scalars; None is an empty subtree.  h5py
is imported by the functions, never with this module.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree"]


def _flatten(tree, leaves: list) -> str:
    """Append the leaves of ``tree`` to ``leaves``; return its structure
    in JAX's ``str(treedef)`` notation."""
    if tree is None:
        return "None"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_flatten(x, leaves) for x in tree)
        if isinstance(tree, list):
            return f"[{inner}]"
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}" for k in sorted(tree)) + "}"
    leaves.append(tree)
    return "*"


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str | Path, tree, metadata: dict | None = None) -> None:
    """Write a tree of arrays and scalars to an HDF5 checkpoint."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves: list = []
    structure = _flatten(tree, leaves)
    with h5py.File(path, "w") as f:
        f.attrs["treedef"] = f"PyTreeDef({structure})"
        f.attrs["n_leaves"] = len(leaves)
        if metadata:
            f.attrs["metadata"] = json.dumps(metadata)
        for i, leaf in enumerate(leaves):
            f.create_dataset(f"leaf_{i}", data=_host(leaf))


def load_pytree(path: str | Path, like=None):
    """(leaves, metadata) of a checkpoint, the leaves as host arrays in
    flatten order; with ``like`` given, (a tree of like's structure, the
    stored arrays as its leaves, metadata).  metadata is None where the
    file has none."""
    import h5py

    with h5py.File(Path(path), "r") as f:
        leaves = [f[f"leaf_{i}"][()] for i in range(int(f.attrs["n_leaves"]))]
        meta = json.loads(f.attrs["metadata"]) if "metadata" in f.attrs else None
    if like is not None:
        return _unflatten(like, iter(leaves)), meta
    return leaves, meta
