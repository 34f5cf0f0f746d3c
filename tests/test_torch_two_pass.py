"""Parity of the port's two-pass fallback with the JAX package.

``sketch_center_gram`` (K2) and ``project`` (K3) at the shapes and
tolerances of tests/test_08_kernels.py:273-343, the JAX side in
interpret mode; ``sketch_center_gram_project`` at a time axis where both
packages take the two passes; the routing rule; and the hourly year
(T = 8,760), which the port takes and the JAX fallback refuses unless
512 divides T (ROADMAP Queue 3, R4).  The port's wrappers take their
plain PyTorch versions on these CPU tensors.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.ops import matmul as mj
from dmd_era5_tpu_torch.ops import _occupancy as occupancy
from dmd_era5_tpu_torch.ops import matmul as mt


def _sketch_parity(rng, m, t, r, **jax_blocks):
    x = rng.standard_normal((m, t)).astype(np.float32)
    w = rng.standard_normal((t, r)).astype(np.float32)
    yc, s1, s2, g = (o.numpy() for o in mt.sketch_center_gram(torch.from_numpy(x), torch.from_numpy(w)))
    yc_j, s1_j, s2_j, g_j = (np.asarray(o) for o in mj.sketch_center_gram(
        jnp.asarray(x), jnp.asarray(w), **jax_blocks))
    assert mt.sketch_center_gram.launches == 0
    xc = x - x.mean(axis=1, keepdims=True)
    return x, xc @ w, (yc, s1, s2, g), (yc_j, s1_j, s2_j, g_j)


def test_sketch_center_gram_kernel(rng):
    """test_08_kernels.py:312-327, and the JAX kernel's outputs to the same."""
    x, y_ref, ours, theirs = _sketch_parity(rng, 1024, 256, 128)
    for out in (ours, theirs):
        yc, s1, s2, g = out
        np.testing.assert_allclose(yc, y_ref, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(s1, x.sum(axis=1), rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(s2, (x * x).sum(axis=1), rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(g, y_ref.T @ y_ref, rtol=1e-4, atol=0.5)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=0.5)


def test_sketch_center_gram_tiled_time(rng):
    """test_08_kernels.py:330-343: the JAX side on its T-tiled kernel
    (K2b), the port on its one kernel."""
    _, y_ref, ours, theirs = _sketch_parity(rng, 512, 512, 64, block_m=256, block_k=128)
    for yc, _, _, g in (ours, theirs):
        np.testing.assert_allclose(yc, y_ref, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(g, y_ref.T @ y_ref, rtol=1e-4, atol=0.5)
    np.testing.assert_allclose(ours[3], theirs[3], rtol=1e-4, atol=0.5)


def test_sketch_center_gram_row_padding(rng):
    """test_08_kernels.py:293-309: 648 rows, a multiple of no block."""
    m, t, r = 648, 24, 8
    x = rng.standard_normal((m, t)).astype(np.float32)
    w = rng.standard_normal((t, r)).astype(np.float32)
    yc, s1, _, g = mt.sketch_center_gram(torch.from_numpy(x), torch.from_numpy(w))
    xc = x - x.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(yc.numpy(), xc @ w, atol=1e-3)
    np.testing.assert_allclose(s1.numpy(), x.sum(axis=1), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), (xc @ w).T @ (xc @ w), rtol=1e-4, atol=1e-2)
    c = mt.project(torch.from_numpy(x), yc).numpy()
    np.testing.assert_allclose(c, yc.numpy().T @ x, rtol=1e-4, atol=1e-2)
    c_j = np.asarray(mj.project(jnp.asarray(x), jnp.asarray(yc.numpy())))
    np.testing.assert_allclose(c, c_j, rtol=1e-4, atol=1e-2)
    assert mt.project.launches == 0


@pytest.mark.parametrize("m,t,r,blocks", [(2048, 256, 64, {}),
                                          (1024, 512, 64, dict(block_m=512, block_t=128))])
def test_project_kernel(rng, m, t, r, blocks):
    """test_08_kernels.py:273-290 (whole and tiled time axis)."""
    x = rng.standard_normal((m, t)).astype(np.float32)
    y = rng.standard_normal((m, r)).astype(np.float32)
    c = mt.project(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    c_j = np.asarray(mj.project(jnp.asarray(x), jnp.asarray(y), **blocks))
    np.testing.assert_allclose(c, y.T @ x, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(c, c_j, rtol=1e-4, atol=1e-2)


def test_project_bf16_operands(rng):
    """bf16 Y or X: the products of the stored values, exact in f32."""
    x = torch.from_numpy(rng.standard_normal((300, 40)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((300, 9)).astype(np.float32))
    for xx, yy in ((x.bfloat16(), y), (x, y.bfloat16()), (x.bfloat16(), y.bfloat16())):
        exact = yy.double().numpy().T @ xx.double().numpy()
        np.testing.assert_allclose(mt.project(xx, yy).numpy(), exact, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("t,n,dtype,two_pass", [
    (8192, 128, torch.float32, False), (8193, 128, torch.float32, True),
    (8704, 16, torch.float32, True), (32768, 128, torch.bfloat16, False),
    (32769, 128, torch.bfloat16, True), (168, 256, torch.float32, False),
    (168, 257, torch.float32, True), (8760, 256, torch.float32, True),
])
def test_routing(t, n, dtype, two_pass):
    """The JAX package leaves its fused kernel once 128 T itemsize passes
    4x its tile budget (T > 8,192 f32, T > 32,768 bf16); the port also
    where K1 cannot go (N > 256)."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    assert mt.takes_two_pass(t, n, itemsize) is two_pass
    assert mt._long_time_axis(t, itemsize) is (two_pass and n <= mt.N_MAX)


@pytest.mark.parametrize("flags", [dict(), dict(scalar_stats=True, emit_yc=False),
                                   dict(stats_col=True, scalar_stats=True)])
def test_fused_entry_takes_two_passes_like_jax(flags):
    """T = 8,704 = 17 x 512: both packages take the fallback; the stats
    come from X (not the ones column), Yc is dropped only on return."""
    m, t, n = 256, 8704, 16
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((m, t)) + 1.5).astype(np.float32)
    w = rng.standard_normal((t, n)).astype(np.float32)
    assert mt.takes_two_pass(t, n, 4)
    before = (mt.sketch_center_gram.launches, mt.project.launches)
    out_t = mt.sketch_center_gram_project(torch.from_numpy(x), torch.from_numpy(w), **flags)
    out_j = mj.sketch_center_gram_project(jnp.asarray(x), jnp.asarray(w), **flags)
    assert (mt.sketch_center_gram.launches, mt.project.launches) == before == (0, 0)
    assert mt.sketch_center_gram_project.launches == 0
    assert (out_t[0] is None) == (out_j[0] is None) == (not flags.get("emit_yc", True))
    # test_08's rtol; its absolute floors were set at T = 256, and f32 sums
    # over 34x as many terms (in another order) are held to 1e-5 of the
    # largest entry instead, the card's tolerance for G and C
    for name, a, b in zip(("yc", "rs", "ss", "G", "C"), out_t, out_j):
        if a is None:
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        if flags.get("stats_col") and name in ("yc", "G", "C"):
            # the ones column centres to roundoff of the row sums in both,
            # which is all its row of C and its row and column of G carry
            if name == "yc":
                limit = 1e-5 * np.abs(x.sum(axis=1)).max()
                assert np.abs(a[:, -1]).max() <= limit and np.abs(b[:, -1]).max() <= limit
            a, b = (a[:, :-1], b[:, :-1]) if name == "yc" else (a[:-1], b[:-1])
            if name == "G":
                a, b = a[:, :-1], b[:, :-1]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_hourly_year_against_f64_oracle():
    """T = 8,760 (a 365-day hourly year), which 512 does not divide: the
    port's two passes against float64 numpy (the JAX fallback refuses
    this shape, see the next test)."""
    m, t, n = 200, 8760, 16
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((m, t)) + 3.0).astype(np.float32)
    w = rng.standard_normal((t, n)).astype(np.float32)
    yc, rs, ss, g, c = (o.numpy() for o in mt.sketch_center_gram_project(
        torch.from_numpy(x), torch.from_numpy(w)))
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    rs64 = x64.sum(axis=1)
    y64 = x64 @ w64 - (rs64 / t)[:, None] * w64.sum(axis=0)[None, :]
    np.testing.assert_allclose(rs, rs64, rtol=1e-5)
    np.testing.assert_allclose(ss, (x64 * x64).sum(axis=1), rtol=1e-5)
    scale = np.abs(y64).max()
    np.testing.assert_allclose(yc, y64, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(g, y64.T @ y64, rtol=0, atol=1e-5 * np.abs(y64.T @ y64).max())
    c64 = yc.astype(np.float64).T @ x64  # C is formed from the stored Yc
    np.testing.assert_allclose(c, c64, rtol=0, atol=1e-5 * np.abs(c64).max())


def test_jax_fallback_refuses_hourly_year():
    """R4, a fault of the reference: past 4 MiB a 128-row tile, the JAX
    fallback tiles T by 512 and asserts that 512 divides it
    (dmd_era5_tpu/ops/matmul.py:524-528)."""
    x = jnp.ones((256, 8760), jnp.float32)
    w = jnp.ones((8760, 16), jnp.float32)
    with pytest.raises(AssertionError):
        mj.sketch_center_gram_project(x, w)


def test_t_valid_in_the_fallback_raises_in_both():
    """A zero-padded time axis needs the fused kernel; past its range both
    packages refuse it (dmd_era5_tpu/ops/matmul.py:375-379)."""
    m, t, n = 128, 8704, 8
    x, w = np.zeros((m, t), np.float32), np.ones((t, n), np.float32)
    with pytest.raises(ValueError, match="t_valid"):
        mt.sketch_center_gram_project(torch.from_numpy(x), torch.from_numpy(w), t_valid=t - 4)
    with pytest.raises(ValueError, match="t_valid"):
        mj.sketch_center_gram_project(jnp.asarray(x), jnp.asarray(w), t_valid=t - 4)
    # at the full width t_valid is no padding: both packages run
    out = mt.sketch_center_gram_project(torch.from_numpy(x), torch.from_numpy(w), t_valid=t)
    assert out[3].shape == (n, n)


def test_wide_sketch_keeps_t_valid(rng):
    """A sketch wider than K1 (N > 256) at a short time axis takes the two
    passes in the port, where the JAX package runs its fused kernel, which
    takes t_valid: the port keeps that, centring by the true count."""
    m, t, t_valid, n = 300, 40, 33, 260
    x = rng.standard_normal((m, t)).astype(np.float32) + 2.0
    x[:, t_valid:] = 0.0
    w = rng.standard_normal((t, n)).astype(np.float32)
    out_t = mt.sketch_center_gram_project(torch.from_numpy(x), torch.from_numpy(w), t_valid=t_valid)
    out_j = mj.sketch_center_gram_project(jnp.asarray(x), jnp.asarray(w), t_valid=t_valid)
    for a, b in zip(out_t, out_j):  # atol as in test_fused_entry_takes_two_passes_like_jax
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max())


def test_checks_and_range():
    x = torch.zeros(10, 12)
    with pytest.raises(ValueError, match="outside the range of the sketch_center_gram kernel"):
        mt.sketch_center_gram(x, torch.zeros(12, mt.SKETCH_N_MAX + 1))
    with pytest.raises(ValueError, match="no kernel for device"):
        mt.sketch_center_gram(x.to("meta"), torch.zeros(12, 4, device="meta"))
    with pytest.raises(ValueError, match="need x"):
        mt.project(x, torch.zeros(11, 4))
    with pytest.raises(ValueError, match="no kernel for device"):
        mt.project(x.to("meta"), torch.zeros(10, 4, device="meta"))
    with pytest.raises(ValueError, match="each be one of"):
        mt.project(x, torch.zeros(10, 4, dtype=torch.float64))


@pytest.mark.parametrize("wave,n_blocks,m,share_bytes", [
    (132, 138, 977_400, 8 * 256 * 8760),    # K3, the year's Hankel pass (N 256)
    (132, 69, 977_400, 8 * 128 * 8760),     # K3, the year's fit step (N 128)
    (132, 6, 15_573_600, 8 * 384 * 168),    # K3, the week's d = 3 pass
    (132, 2415, 977_400, 8 * 8760 * 8760),  # K5, the year (scratch caps it at one share)
    (264, 6, 15_573_600, 8 * 168 * 168),    # K5, the week at two CTAs an SM
    (132, 138, 300, 8 * 256 * 8760),        # fewer row tiles than the best split
    (132, 1, 1, 8),
])
def test_wave_row_shares(wave, n_blocks, m, share_bytes):
    """The tensor-core reduction's row shares: the fewest whose CTAs fill
    whole waves within 3% of the best split, within one share a 128-row
    tile and 1 GiB of f64 scratch (checked against a brute-force search)."""
    s = occupancy.wave_row_shares(wave, n_blocks, m, share_bytes)
    cap = min(-(-m // 128), (1 << 30) // share_bytes, 65535)
    assert 1 <= s <= max(1, cap)

    def cost(k):
        return -(-(n_blocks * k) // wave) / k

    best = min(cost(k) for k in range(1, max(1, cap) + 1))
    assert cost(s) <= 1.03 * best
    assert all(cost(k) > 1.03 * best for k in range(1, s))
