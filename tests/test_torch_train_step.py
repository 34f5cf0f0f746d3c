"""Parity of the port's fused fit step with the JAX package.

Same X and the same omega (numpy, from a seed) through
``dmd_era5_tpu.pipeline.train_step.fit_step_fused`` and its port, for
each small-algebra route and each ingest variant, at the tolerances of
tests/test_07_train_step.py.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.pipeline.train_step import fit_step_fused as fit_jax
from dmd_era5_tpu_torch.convert import fit_state_from_numpy
from dmd_era5_tpu_torch.pipeline.train_step import fit_step_fused as fit_torch

S, T, R, K = 500, 96, 24, 12


@pytest.mark.parametrize(
    "method,variant",
    list(itertools.product(["hybrid", "cholqr", "eigh2"],
                           ["f32", "stats_from_sketch", "t_valid", "bf16"])),
)
def test_fit_step_fused_parity(method, variant):
    rng = np.random.default_rng(11)
    x = np.einsum(
        "sr,rt->st",
        rng.standard_normal((S, 16)) * (np.arange(16, 0, -1) ** 1.5),
        rng.standard_normal((16, T)),
    ).astype(np.float32)
    # the noise holds cond(G) of the sketch near 2e4: the eigh2 route
    # takes an f32 eigh of G, which resolves its spectrum only to about
    # eps_f32 * cond(G), and two LAPACK eigh builds differ at that level
    x += 4.0 * rng.standard_normal((S, T)).astype(np.float32) + 3.0
    t_valid = None
    if variant == "t_valid":  # time axis zero-padded past the true columns
        t_valid = T
        x = np.pad(x, ((0, 0), (0, 8)))
    omega = rng.standard_normal((x.shape[1], R)).astype(np.float32)
    kw = dict(n_components=K, small_algebra=method, t_valid=t_valid,
              stats_from_sketch=variant == "stats_from_sketch")

    if variant == "bf16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
        st = fit_torch(xt, torch.from_numpy(omega), gemm_dtype=torch.bfloat16, **kw)
        sj = fit_jax(xj, jnp.asarray(omega), gemm_dtype=jnp.bfloat16, **kw)
    else:
        st = fit_torch(torch.from_numpy(x), torch.from_numpy(omega), **kw)
        sj = fit_jax(jnp.asarray(x), jnp.asarray(omega), **kw)

    sj = fit_state_from_numpy(*sj)  # the JAX state as the port's type
    u_t, s_t, v_t, a_t = (o.float().numpy() for o in st[:4])
    u_j, s_j, v_j, a_j = (o.numpy() for o in sj[:4])
    assert u_t.shape == (S, K) and v_t.shape == (K, T)
    if variant == "bf16":
        # both sides take the same bf16 X; a stored Yc entry may round the
        # other way where the f32 sums differ in order
        np.testing.assert_allclose(s_t[:4], s_j[:4], rtol=2e-2)  # test_07:205
    else:
        np.testing.assert_allclose(s_t, s_j, rtol=1e-3)  # test_07:46
    np.testing.assert_allclose(float(st.loss), float(sj.loss), atol=5e-3)  # :68
    # only components above the f32 noise floor carry meaning (the hybrid
    # route divides by s without a floor); eigh's signs are arbitrary, so
    # align each column by its right vector first
    keep = s_j > np.sqrt(np.finfo(np.float32).eps) * s_j[0]
    signs = np.sign(np.sum(v_t * v_j, axis=1))
    np.testing.assert_allclose((u_t * signs)[:, keep], u_j[:, keep], atol=1e-3)
    np.testing.assert_allclose((v_t * signs[:, None])[keep], v_j[keep], atol=1e-3)
    # a_red up to that sign conjugation: compare its spectrum
    e_t = np.sort_complex(np.linalg.eigvals(a_t.astype(np.float64)))
    e_j = np.sort_complex(np.linalg.eigvals(a_j.astype(np.float64)))
    np.testing.assert_allclose(e_t, e_j, atol=5e-3)
    # orthonormal basis
    np.testing.assert_allclose(u_t.T @ u_t, np.eye(K), atol=1e-3)
