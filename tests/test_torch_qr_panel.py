"""Parity of the port's Gram kernel wrapper, CholeskyQR leaves and TSQR
leaves with the JAX package.

The same numpy inputs go through ``dmd_era5_tpu.ops.qr_panel`` /
``ops.tsqr`` (Pallas in interpret mode on the CPU) and the port, whose
wrappers take their plain PyTorch versions for CPU tensors.  Tolerances
are the JAX tests' own, cited at each assertion.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.ops import qr_panel as jqr
from dmd_era5_tpu.ops.tsqr import _local_factor as local_factor_jax
from dmd_era5_tpu.ops.tsqr import qr_positive as qr_positive_jax
from dmd_era5_tpu.ops.tsqr import tsqr as tsqr_jax
from dmd_era5_tpu_torch.ops import qr_panel
from dmd_era5_tpu_torch.ops.tsqr import _local_factor, default_qr_method, qr_positive, tsqr

JAX_PRECISION = {"highest": jax.lax.Precision.HIGHEST, "bf16_split": "bf16_split"}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _ill_conditioned(rng, m=2048, n=48):
    """tests/test_08_kernels.py:67-70: eight columns scaled by 1e3."""
    a = rng.standard_normal((m, n)).astype(np.float32)
    a[:, :8] *= 1e3
    return a


@pytest.mark.parametrize("precision", ["highest", "bf16_split"])
@pytest.mark.parametrize("m,k", [(300, 32), (1037, 24), (2048, 64)])
def test_gram_parity(rng, precision, m, k):
    """Against f64 and the JAX ``gram`` (test_25_linalg.py:91-103: 1e-5
    of max|G| for HIGHEST, 3e-5 for the split); M = 1037 is ragged for
    the JAX kernel's 1024-row blocks."""
    a = rng.standard_normal((m, k)).astype(np.float32)
    g_t = qr_panel.gram(_t(a), precision=precision).numpy()
    g_j = np.asarray(jqr.gram(jnp.asarray(a), precision=JAX_PRECISION[precision]))
    g_ref = a.astype(np.float64).T @ a.astype(np.float64)
    tol = (1e-5 if precision == "highest" else 3e-5) * np.abs(g_ref).max()
    assert g_t.dtype == np.float32 and g_t.shape == (k, k)
    assert np.allclose(g_t, g_ref, rtol=0, atol=tol)
    assert np.allclose(g_t, g_j, rtol=0, atol=tol)


def test_gram_bf16_input_highest(rng):
    """bf16 A at HIGHEST: its values are exact in f32, so G is their f64
    Gram to f32 roundoff (test_25_linalg.py:102, 1e-5 of max|G|)."""
    a = rng.standard_normal((500, 40)).astype(np.float32)
    a_t = _t(a).to(torch.bfloat16)
    g_t = qr_panel.gram(a_t).numpy()
    a64 = a_t.double().numpy()
    g_ref = a64.T @ a64
    g_j = np.asarray(jqr.gram(jnp.asarray(a, dtype=jnp.bfloat16)))
    tol = 1e-5 * np.abs(g_ref).max()
    assert np.allclose(g_t, g_ref, rtol=0, atol=tol)
    assert np.allclose(g_t, g_j, rtol=0, atol=tol)


def test_cholqr_reconstructs(rng):
    """test_08_kernels.py:61-64: Q R == A to 1e-3; and the JAX factors."""
    a = rng.standard_normal((1024, 32)).astype(np.float32)
    q_t, r_t = qr_panel.cholqr(_t(a))
    assert q_t.is_contiguous()  # row-major, as the next Gram pass takes it
    q, r = q_t.numpy(), r_t.numpy()
    q_j, r_j = (np.asarray(o) for o in jqr.cholqr(jnp.asarray(a)))
    np.testing.assert_allclose(q @ r, a, atol=1e-3)
    np.testing.assert_allclose(r, r_j, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(q, q_j, atol=1e-4)


def test_cholqr2_orthonormal_ill_conditioned(rng):
    """test_08_kernels.py:67-78, tolerances as there."""
    a = _ill_conditioned(rng)
    q, r = (o.numpy() for o in qr_panel.cholqr2(_t(a)))
    np.testing.assert_allclose(q.T @ q, np.eye(48), atol=5e-4)
    np.testing.assert_allclose(q @ r, a, rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(np.tril(r, -1), 0.0, atol=1e-2)
    q_j, r_j = (np.asarray(o) for o in jqr.cholqr2(jnp.asarray(a)))
    np.testing.assert_allclose(r, r_j, rtol=2e-3, atol=2e-2)


def test_cholqr2_split_accuracy():
    """test_08_kernels.py:496-519 (cond ~1e3 panel), tolerances as there,
    and R against the JAX leaf's."""
    rng = np.random.default_rng(0)
    u, _ = np.linalg.qr(rng.standard_normal((2048, 96)))
    v, _ = np.linalg.qr(rng.standard_normal((96, 96)))
    a = ((u * np.logspace(0, -3, 96)) @ v.T).astype(np.float32)
    q, r = (o.numpy() for o in qr_panel.cholqr2_split(_t(a)))
    assert np.abs(q.T @ q - np.eye(96)).max() < 5e-6
    assert np.linalg.norm(a - q @ r) / np.linalg.norm(a) < 5e-6
    assert np.all(np.diag(r) > 0)
    s_ref = np.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(np.linalg.svd(r, compute_uv=False)[:8], s_ref[:8], rtol=1e-5)
    _, r_j = jqr.cholqr2_split(jnp.asarray(a))
    np.testing.assert_allclose(r, np.asarray(r_j), atol=5e-6 * np.abs(r).max())


def test_qr_positive_convention(rng):
    """test_03_svd.py:51-55, and the JAX factors."""
    x = rng.standard_normal((64, 8)).astype(np.float32)
    q, r = (o.numpy() for o in qr_positive(_t(x)))
    assert np.all(np.diagonal(r) >= 0)
    np.testing.assert_allclose(q @ r, x, atol=1e-5)
    q_j, r_j = (np.asarray(o) for o in qr_positive_jax(jnp.asarray(x)))
    np.testing.assert_allclose(r, r_j, atol=1e-5)
    np.testing.assert_allclose(q, q_j, atol=1e-5)


@pytest.mark.parametrize("method", ["householder", "cholqr2", "cholqr2_split"])
def test_local_factor_parity(rng, method):
    """Each leaf against the JAX leaf of the same name on the CPU (its
    Householder leaf is LAPACK there): the unique positive-diagonal QR,
    to the single-device TSQR tolerance of test_03_svd.py:58-64 (2e-4)."""
    x = rng.standard_normal((1024, 24)).astype(np.float32)
    q, r = (o.numpy() for o in _local_factor(_t(x), method))
    q_j, r_j = (np.asarray(o) for o in local_factor_jax(jnp.asarray(x), method))
    np.testing.assert_allclose(r, r_j, atol=2e-4)
    np.testing.assert_allclose(q, q_j, atol=2e-4)
    np.testing.assert_allclose(q.T @ q, np.eye(24), atol=5e-5)  # test_03_svd.py:72


def test_tsqr_default_method_on_cpu(rng):
    """A CPU tensor takes the JAX package's non-TPU default leaf."""
    x = rng.standard_normal((512, 16)).astype(np.float32)
    assert default_qr_method(_t(x)) == "householder"
    q, r = (o.numpy() for o in tsqr(_t(x)))
    q_j, r_j = (np.asarray(o) for o in tsqr_jax(jnp.asarray(x)))
    np.testing.assert_allclose(r, r_j, atol=2e-4)
    np.testing.assert_allclose(q, q_j, atol=2e-4)


def test_split_leaf_on_row_centred_panel_matches_jax_fault():
    """A row-centred panel (X 1 = 0, so rank-deficient) is outside the
    split CholQR2 leaf's range (dmd_era5_tpu/ops/qr_panel.py:200-202):
    Q's null column is left unnormalized, the second split Gram pass is
    then nearly singular, and U from R's leading singular vectors is
    orthonormal only to ~1e-3 — in the JAX leaf as in the port, which
    agree to 1e-5 there.  The full-f32 leaf keeps U orthonormal to 1e-6.
    ``chip_smoke.py`` reads the same fault at ERA5 size (ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    m, t = 2048, 64
    hours = np.arange(t)
    x = np.zeros((m, t))
    for damp, period, amp in ((-0.002, 24.0, 12.0), (-0.004, 12.0, 8.0), (-0.001, 84.0, 6.0)):
        c = rng.standard_normal(m) + 1j * rng.standard_normal(m)
        x += amp * np.real(np.outer(c, np.exp((damp + 2j * np.pi / period) * hours)))
    x += 0.15 * rng.standard_normal((m, t)) + 250.0
    x = (x - x.mean(axis=1, keepdims=True)).astype(np.float32)

    def u_dev(q, r):
        u_r = np.linalg.svd(np.asarray(r, np.float64))[0][:, : t // 2]
        u = np.asarray(q, np.float64) @ u_r
        return np.abs(u.T @ u - np.eye(t // 2)).max()

    dev_t = u_dev(*(o.numpy() for o in qr_panel.cholqr2_split(_t(x))))
    dev_j = u_dev(*jqr.cholqr2_split(jnp.asarray(x)))
    assert dev_t > 5e-4 and dev_j > 5e-4
    assert abs(dev_t - dev_j) <= 1e-5
    assert u_dev(*(o.numpy() for o in qr_panel.cholqr2(_t(x)))) < 1e-6
