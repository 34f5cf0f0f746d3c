"""Parity of the port's checkpoints and checkpointed LM with the JAX
package's.

tests/test_13_checkpoint.py's three checkpoint cases through
``dmd_era5_tpu_torch.utils.checkpoint`` and
``models.optdmd.varpro_lm_checkpointed`` on the CPU: a pytree round trip
(each package reading what the other wrote), the chunked solve against
the direct one (eigenvalues to 1e-4, residual to 1e-5, test_13's
tolerances), and a solve stopped midway and resumed from its file, the
file written by either package and resumed by the other (the planted
eigenvalues to 5e-3, and the port's resumed solve against the JAX
package's from the same file to 1e-4).
"""

from __future__ import annotations

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_13_checkpoint import _lm_problem

from dmd_era5_tpu.models import optdmd as optdmd_jax
from dmd_era5_tpu.utils import checkpoint as checkpoint_jax
from dmd_era5_tpu_torch.convert import lm_state_from_numpy
from dmd_era5_tpu_torch.models.optdmd import varpro_lm, varpro_lm_checkpointed
from dmd_era5_tpu_torch.utils.checkpoint import load_pytree, save_pytree

STATE_LIKE = (np.zeros(4, np.float32), np.float32(0), np.float32(0), np.int32(0), np.bool_(False))


def _problem(rng):
    h, t, alpha0, alpha_true = _lm_problem(rng)
    return np.asarray(h), np.asarray(t), np.asarray(alpha0), alpha_true


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pytree_roundtrip(tmp_path, writer):
    """One layout: the tree and its metadata back from a file either
    package wrote, read by both."""
    tree = {"a": torch.arange(6).reshape(2, 3), "b": (torch.tensor(1.5), torch.ones(4))}
    path = tmp_path / "ckpt.h5"
    if writer == "port":
        save_pytree(path, tree, metadata={"step": 7})
    else:
        jtree = {"a": jnp.arange(6).reshape(2, 3), "b": (jnp.float32(1.5), jnp.ones(4))}
        checkpoint_jax.save_pytree(path, jtree, metadata={"step": 7})
    back, meta = load_pytree(path, like=tree)
    assert meta == {"step": 7}
    np.testing.assert_array_equal(back["a"], np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(back["b"][1], np.ones(4))
    assert float(back["b"][0]) == 1.5
    leaves_j, meta_j = checkpoint_jax.load_pytree(path)
    leaves, _ = load_pytree(path)
    assert meta_j == meta and len(leaves) == len(leaves_j) == 3
    for a, b in zip(leaves, leaves_j):
        np.testing.assert_array_equal(a, b)
    import h5py

    with h5py.File(path, "r") as f:
        assert f.attrs["treedef"] == "PyTreeDef({'a': *, 'b': (*, *)})"


def test_checkpointed_matches_direct(tmp_path, rng):
    h, t, alpha0, _ = _problem(rng)
    a_direct, _, rel_direct, n_direct = varpro_lm(h, t, alpha0, max_iter=30)
    a_ck, _, rel_ck, n_ck = varpro_lm_checkpointed(h, t, alpha0, str(tmp_path / "lm.h5"),
                                                   max_iter=30, chunk_iters=5)
    np.testing.assert_allclose(a_ck.numpy(), a_direct.numpy(), atol=1e-4)
    assert abs(float(rel_ck) - float(rel_direct)) < 1e-5
    assert n_ck == n_direct
    # and the JAX package's chunked solve of the same problem
    a_j, _, rel_j, _ = optdmd_jax.varpro_lm_checkpointed(
        jnp.asarray(h), jnp.asarray(t), jnp.asarray(alpha0), str(tmp_path / "lm_jax.h5"),
        max_iter=30, chunk_iters=5)
    found = sorted(a_ck.numpy(), key=lambda z: z.imag)
    np.testing.assert_allclose(found, sorted(np.asarray(a_j), key=lambda z: z.imag), atol=1e-4)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpointed_resumes_from_file(tmp_path, rng, writer):
    """A solve capped early leaves a mid-solve checkpoint; the solve then
    resumes from it (in the other package too) rather than restarting."""
    h, t, alpha0, alpha_true = _problem(rng)
    path = str(tmp_path / "lm.h5")
    if writer == "port":
        varpro_lm_checkpointed(h, t, alpha0, path, max_iter=4, chunk_iters=2)
    else:
        optdmd_jax.varpro_lm_checkpointed(jnp.asarray(h), jnp.asarray(t), jnp.asarray(alpha0),
                                          path, max_iter=4, chunk_iters=2)
    state, meta = load_pytree(path, like=STATE_LIKE)
    assert meta["iteration"] >= 1 and int(state[3]) == meta["iteration"]
    # the state as the solver takes it: resuming it directly continues the count
    resumed = varpro_lm(h, t, alpha0, max_iter=meta["iteration"] + 1,
                        state0=lm_state_from_numpy(*state), return_state=True)
    assert resumed[3] == meta["iteration"] + 1 or bool(resumed[4][4])
    other = str(tmp_path / "lm_other.h5")
    shutil.copy(path, other)

    a_res, _, rel_res, n_res = varpro_lm_checkpointed(h, t, alpha0, path, max_iter=40,
                                                      chunk_iters=10)
    assert n_res >= meta["iteration"]
    found = sorted(a_res.numpy(), key=lambda z: z.imag)
    np.testing.assert_allclose(found, sorted(alpha_true, key=lambda z: z.imag), atol=5e-3)
    a_j, _, rel_j, n_j = optdmd_jax.varpro_lm_checkpointed(
        jnp.asarray(h), jnp.asarray(t), jnp.asarray(alpha0), other, max_iter=40, chunk_iters=10)
    np.testing.assert_allclose(found, sorted(np.asarray(a_j), key=lambda z: z.imag), atol=1e-4)
    assert abs(float(rel_res) - float(rel_j)) < 1e-5
    # each package's final checkpoint loads in the other
    for p in (path, other):
        leaves_j, meta_j = checkpoint_jax.load_pytree(p)
        leaves, meta_t = load_pytree(p)
        assert meta_j == meta_t and [a.dtype for a in leaves] == [a.dtype for a in leaves_j]
