"""Parity of the port's fused sketch/centre/Gram/projection pass and its
tiled matmul.

The same numpy inputs go through ``dmd_era5_tpu.ops.matmul.
sketch_center_gram_project`` and ``matmul`` (Pallas in interpret mode on
the CPU) and the port's wrappers, which take their plain PyTorch
versions for a CPU tensor.  Every flag combination of the fused pass, in
float32 and bfloat16; the matmul at the JAX tests' shapes and at ragged
ones the JAX entry refuses.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.ops.matmul import matmul as matmul_jax
from dmd_era5_tpu.ops.matmul import sketch_center_gram_project as scgp_jax
from dmd_era5_tpu_torch.ops.matmul import matmul as matmul_torch
from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project as scgp_torch

M, T = 333, 40  # M is a multiple of no block size of either kernel

CASES = [
    pytest.param(dtype, center, stats_col, scalar_stats, t_valid, emit_yc,
                 id=f"{dtype}-c{center:d}-sc{stats_col:d}-ss{scalar_stats:d}"
                    f"-tv{t_valid is not None:d}-e{emit_yc:d}")
    for dtype, center, stats_col, scalar_stats, t_valid, emit_yc in itertools.product(
        ["float32", "bfloat16"], [True, False], [False, True], [False, True],
        [None, T - 5], [True, False],
    )
]


@pytest.mark.parametrize(
    "dtype,center,stats_col,scalar_stats,t_valid,emit_yc", CASES
)
def test_sketch_center_gram_project_parity(
    dtype, center, stats_col, scalar_stats, t_valid, emit_yc
):
    # both sketch widths, spread over the flag combinations
    n = 32 if (center ^ stats_col ^ emit_yc) else 64
    _check_parity(dtype, T, n, center, stats_col, scalar_stats, t_valid, emit_yc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("center,stats_col,scalar_stats,t_valid,emit_yc",
                         [(True, False, True, None, True), (True, True, False, 295, False),
                          (False, False, False, None, True)])
def test_sketch_center_gram_project_parity_long_time_axis(
    dtype, center, stats_col, scalar_stats, t_valid, emit_yc
):
    """T = 300, past the f32 depth of W that the card's sketch stage holds
    at once (168), with a sketch past one of its 112-wide CTA columns.
    Here G and C reach ~1e5, where f32 sums in another order differ by
    more than test_08's absolute 1e-2: in f32 they are held to 1e-5 of
    their largest entry, the JAX tests' Gram tolerance
    (test_25_linalg.py:102)."""
    _check_parity(dtype, 300, 200, center, stats_col, scalar_stats, t_valid, emit_yc,
                  gc_rel_to_max=1e-5)


def _check_parity(dtype, t, n, center, stats_col, scalar_stats, t_valid, emit_yc,
                  gc_rel_to_max=None):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((M, t)).astype(np.float32) + 2.0
    if t_valid is not None:
        x[:, t_valid:] = 0.0  # zero-padded trailing columns
    w = rng.standard_normal((t, n)).astype(np.float32)
    tdt = getattr(torch, dtype)
    # quantize once in torch; the f32 copies hold the exact bf16 values
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    xj = jnp.asarray(xt.float().numpy()).astype(dtype)
    wj = jnp.asarray(wt.float().numpy()).astype(dtype)
    flags = dict(center=center, stats_col=stats_col, scalar_stats=scalar_stats,
                 t_valid=t_valid, emit_yc=emit_yc)

    out_t = scgp_torch(xt, wt, out_dtype=tdt, **flags)
    out_j = scgp_jax(xj, wj, out_dtype=getattr(jnp, dtype), **flags)
    assert scgp_torch.launches == 0  # CPU tensors never reach the kernel

    yc_t, rs_t, ss_t, g_t, c_t = (
        None if o is None else o.float().numpy() for o in out_t
    )
    yc_j, rs_j, ss_j, g_j, c_j = (
        None if o is None else np.asarray(o, dtype=np.float32) for o in out_j
    )
    assert (yc_t is None) == (not emit_yc)
    if scalar_stats:
        assert np.shape(rs_t) == () and np.shape(ss_t) == ()
    else:
        assert rs_t.shape == (M,) and ss_t.shape == (M,)
    np.testing.assert_allclose(rs_t, rs_j, rtol=1e-4, atol=1e-2)
    # under stats_col the port rounds each x*x to bf16 before summing, as
    # the Pallas kernel's bf16 product does on the chip; XLA on the CPU
    # keeps the square in f32 (excess precision), so the two sums differ
    # by the squares' rounding: at most half a bf16 ulp each
    ss_rtol = 2**-9 if (stats_col and dtype == "bfloat16") else 1e-4
    np.testing.assert_allclose(ss_t, ss_j, rtol=ss_rtol, atol=1e-2)
    if dtype == "float32":
        # test_08_kernels.py:293-326
        if emit_yc:
            np.testing.assert_allclose(yc_t, yc_j, rtol=0, atol=1e-3)
        for got, ref in ((g_t, g_j), (c_t, c_j)):
            if gc_rel_to_max is None:
                np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-2)
            else:
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=gc_rel_to_max * np.abs(ref).max())
    else:
        # f32 sums in another order can flip a bf16 rounding: Yc within
        # one bf16 ulp, G and C within the spread that flip causes
        if emit_yc:
            np.testing.assert_allclose(
                yc_t, yc_j, rtol=8e-3, atol=8e-3 * np.abs(yc_j).max() * 2**-8
            )
        np.testing.assert_allclose(g_t, g_j, rtol=2e-2, atol=2e-2 * np.abs(g_j).max() * 2**-8)
        np.testing.assert_allclose(c_t, c_j, rtol=2e-2, atol=2e-2 * np.abs(c_j).max() * 2**-8)


def test_matmul_f32_parity(rng):
    """tests/test_08_kernels.py:28-32 (rtol 1e-5, atol 1e-3 against
    numpy), and the JAX kernel's output to the same."""
    x = rng.standard_normal((1024, 512)).astype(np.float32)
    w = rng.standard_normal((512, 256)).astype(np.float32)
    out = matmul_torch(torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.float32 and matmul_torch.launches == 0
    out_j = np.asarray(matmul_jax(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(out.numpy(), x @ w, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(out.numpy(), out_j, rtol=1e-5, atol=1e-3)


def test_matmul_bf16_parity(rng):
    """tests/test_08_kernels.py:35-42: bf16 operands, f32 out.  Each
    product of two bf16 values is exact in f32, so against the f64
    product of the rounded operands the only error is the f32 sum, and
    against the JAX kernel the order of that sum."""
    x = rng.standard_normal((512, 512)).astype(np.float32)
    w = rng.standard_normal((512, 128)).astype(np.float32)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    out = matmul_torch(xt, wt).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, x @ w, rtol=5e-2, atol=2.0)
    exact = xt.double().numpy() @ wt.double().numpy()
    np.testing.assert_allclose(out, exact, rtol=1e-5, atol=1e-3)
    out_j = np.asarray(matmul_jax(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)))
    np.testing.assert_allclose(out, out_j, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (333, 40, 110), (1000, 168, 130), (7, 300, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_matmul_ragged_shapes(rng, m, k, n, dtype, out_dtype):
    """Shapes no block divides, which the JAX entry refuses (a TPU tiling
    constraint) and the port takes: against numpy's f64 product of the
    stored operands, rounded once to ``out_dtype``."""
    tdt, odt = getattr(torch, dtype), getattr(torch, out_dtype)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(tdt)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(tdt)
    out = matmul_torch(x, w, out_dtype=odt)
    assert out.dtype == odt and out.shape == (m, n)
    exact = torch.from_numpy(x.double().numpy() @ w.double().numpy())
    np.testing.assert_allclose(out.double().numpy(), exact.to(odt).double().numpy(),
                               rtol=2.0**-7 if out_dtype == "bfloat16" else 1e-5, atol=1e-3)


def test_matmul_checks():
    x = torch.zeros(10, 12)
    with pytest.raises(ValueError, match="share one dtype"):
        matmul_torch(x, torch.zeros(12, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="need x"):
        matmul_torch(x, torch.zeros(11, 4))
    with pytest.raises(ValueError, match="out_dtype"):
        matmul_torch(x, torch.zeros(12, 4), out_dtype=torch.float64)
    with pytest.raises(ValueError, match="empty"):
        matmul_torch(torch.zeros(0, 12), torch.zeros(12, 4))
