"""Parity of the port's fused fit step with the JAX package.

Same X and the same omega (numpy, from a seed) through
``dmd_era5_tpu.pipeline.train_step.fit_step_fused`` and its port, for
each small-algebra route and each ingest variant, at the tolerances of
tests/test_07_train_step.py; ``fit_step_lean`` likewise; and both steps
at a time axis past the JAX package's fused kernel, where they take the
two-pass fallback.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.pipeline.train_step import fit_step_fused as fit_jax
from dmd_era5_tpu.pipeline.train_step import fit_step_lean as lean_jax
from dmd_era5_tpu_torch.convert import fit_state_from_numpy
from dmd_era5_tpu_torch.ops import matmul as matmul_torch
from dmd_era5_tpu_torch.pipeline.train_step import fit_step_fused as fit_torch
from dmd_era5_tpu_torch.pipeline.train_step import fit_step_lean as lean_torch

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

    _assert_states_agree(st, sj, bf16=variant == "bf16")


def _assert_states_agree(st, sj, bf16=False, k=K):
    sj = fit_state_from_numpy(*sj, device="cpu")  # the JAX state as the port's type
    u_t, s_t, v_t, a_t = (o.float().numpy() for o in st[:4])
    u_j, s_j, v_j, a_j = (o.numpy() for o in sj[:4])
    assert u_t.shape == u_j.shape and v_t.shape == v_j.shape
    if bf16:
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
    np.testing.assert_allclose(u_t.T @ u_t, np.eye(k), atol=1e-3)


def _lowrank(rng, s_rows, t_cols, rank=16, noise=4.0):
    x = np.einsum(
        "sr,rt->st",
        rng.standard_normal((s_rows, rank)) * (np.arange(rank, 0, -1) ** 1.5),
        rng.standard_normal((rank, t_cols)),
    ).astype(np.float32)
    return x + noise * rng.standard_normal((s_rows, t_cols)).astype(np.float32) + 3.0


@pytest.mark.parametrize("t_valid", [None, T])
def test_fit_step_lean_parity(t_valid):
    """fit_step_lean (no Yc emitted, centring folded into the lift) against
    the JAX function, with and without a zero-padded time axis."""
    rng = np.random.default_rng(13)
    x = _lowrank(rng, S, T)
    omega = rng.standard_normal((T, R)).astype(np.float32)
    if t_valid is not None:  # zero pad columns of X and rows of omega (test_07:555-559)
        x, omega = np.pad(x, ((0, 0), (0, 8))), np.pad(omega, ((0, 8), (0, 0)))
    st = lean_torch(torch.from_numpy(x), torch.from_numpy(omega), K, t_valid=t_valid)
    sj = lean_jax(jnp.asarray(x), jnp.asarray(omega), n_components=K, t_valid=t_valid)
    assert st.u.dtype == torch.float32 and st.v.shape == (K, T)
    _assert_states_agree(st, sj)
    # and the port's lean step against its own fused one (test_07:525-566)
    sf = fit_torch(torch.from_numpy(x), torch.from_numpy(omega), n_components=K, t_valid=t_valid)
    np.testing.assert_allclose(st.s.numpy(), sf.s.numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(st.loss), float(sf.loss), rtol=1e-4)
    np.testing.assert_allclose(np.abs(st.u.numpy()), np.abs(sf.u.numpy()), atol=1e-4)


def test_fit_step_lean_bf16_u_dtype():
    rng = np.random.default_rng(17)
    x = torch.from_numpy(_lowrank(rng, S, T))
    omega = torch.from_numpy(rng.standard_normal((T, R)).astype(np.float32))
    st = lean_torch(x, omega, K, gemm_dtype=torch.bfloat16, u_dtype=torch.bfloat16)
    sf = lean_torch(x, omega, K, gemm_dtype=torch.bfloat16)
    assert st.u.dtype == torch.bfloat16 and sf.u.dtype == torch.float32
    # a bf16 lift matrix and a bf16 U: two roundings of 2^-9 relative each
    rel = float((st.u.float() - sf.u).norm() / sf.u.norm())
    assert rel <= 2.0**-7, rel


@pytest.mark.parametrize("step,stats_from_sketch", [("fused", False), ("fused", True),
                                                    ("lean", False)])
def test_fit_steps_take_the_two_pass_fallback_at_long_t(monkeypatch, step, stats_from_sketch):
    """T = 8,704 > 8,192 in f32: the JAX package's fit step takes its
    fallback there (scalar stats summed after the passes; under
    ``stats_from_sketch`` the ones column enters W, the stats come from
    X), and so does the port's, through K2 and K3's plain versions."""
    s_rows, t_cols, k = 96, 8704, 6
    rng = np.random.default_rng(19)
    x = _lowrank(rng, s_rows, t_cols, rank=8)
    omega = rng.standard_normal((t_cols, 12)).astype(np.float32)
    calls = []
    real = matmul_torch._two_pass
    monkeypatch.setattr(matmul_torch, "_two_pass", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    if step == "lean":
        st = lean_torch(torch.from_numpy(x), torch.from_numpy(omega), k)
        sj = lean_jax(jnp.asarray(x), jnp.asarray(omega), n_components=k)
    else:
        kw = dict(n_components=k, stats_from_sketch=stats_from_sketch)
        st = fit_torch(torch.from_numpy(x), torch.from_numpy(omega), **kw)
        sj = fit_jax(jnp.asarray(x), jnp.asarray(omega), **kw)
    assert calls == [1]
    if not stats_from_sketch:
        _assert_states_agree(st, sj, k=k)
        return
    # the ones column of W centres to roundoff, which the two packages sum
    # in other orders: s at test_07:46's tolerance, the loss and U^T U at
    # test_07:242-300's, U by its subspace at test_20's angle (the two
    # trailing components sit near the noise floor and turn by ~2e-2)
    np.testing.assert_allclose(st.s.numpy(), np.asarray(sj.s), rtol=1e-3)
    np.testing.assert_allclose(float(st.loss), float(sj.loss), rtol=3e-3, atol=1e-6)
    u_t, u_j = st.u.double().numpy(), np.asarray(sj.u, dtype=np.float64)
    np.testing.assert_allclose(u_t.T @ u_t, np.eye(k), atol=2e-3)
    cos = np.linalg.svd(np.linalg.qr(u_t)[0].T @ np.linalg.qr(u_j)[0], compute_uv=False)
    assert np.arccos(min(cos.min(), 1.0)) < 5e-2, cos.min()
