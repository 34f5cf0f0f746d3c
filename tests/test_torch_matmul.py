"""Parity of the port's fused sketch/centre/Gram/projection pass.

The same numpy inputs go through ``dmd_era5_tpu.ops.matmul.
sketch_center_gram_project`` (Pallas in interpret mode on the CPU) and
the port's wrapper, which takes its plain PyTorch version for a CPU
tensor.  Every flag combination, in float32 and bfloat16.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.ops.matmul import sketch_center_gram_project as scgp_jax
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
    rng = np.random.default_rng(3)
    x = rng.standard_normal((M, T)).astype(np.float32) + 2.0
    if t_valid is not None:
        x[:, t_valid:] = 0.0  # zero-padded trailing columns
    w = rng.standard_normal((T, n)).astype(np.float32)
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
        np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-2)
    else:
        # f32 sums in another order can flip a bf16 rounding: Yc within
        # one bf16 ulp, G and C within the spread that flip causes
        if emit_yc:
            np.testing.assert_allclose(
                yc_t, yc_j, rtol=8e-3, atol=8e-3 * np.abs(yc_j).max() * 2**-8
            )
        np.testing.assert_allclose(g_t, g_j, rtol=2e-2, atol=2e-2 * np.abs(g_j).max() * 2**-8)
        np.testing.assert_allclose(c_t, c_j, rtol=2e-2, atol=2e-2 * np.abs(c_j).max() * 2**-8)
