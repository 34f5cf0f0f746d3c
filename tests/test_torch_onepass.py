"""Parity of the port's one-pass (two-sided sketch) SVD with the JAX
package's: ``ops/onepass.py`` and ``streamed_onepass_svd``, the cases
of ``tests/test_17_onepass.py`` through both packages.

The port's sketch Omega comes from a torch generator; every comparison
with the JAX package passes the JAX package's own Omega,
``jax.random.normal(fold_in(key(seed), 0x0E6A), (T, r))``, through the
``omega=`` seam, so both run the same sketches.  The left panel Psi is
generated by both from (seed, row offset) and must agree bit for bit.
The port sums W and G in float64 and solves the core in float64, the
JAX package in f32: each test holds the port to the JAX test's
tolerance (stated there) or a tighter one.  The kernels take their plain
PyTorch versions on the CPU and count no launch.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.ops import onepass as jop
from dmd_era5_tpu.pipeline import streamed_fit as jsf
from dmd_era5_tpu.snapmat import loader as jloader
from dmd_era5_tpu_torch.ops import matmul as tmatmul
from dmd_era5_tpu_torch.ops import onepass as top
from dmd_era5_tpu_torch.ops import qr_panel as tqr
from dmd_era5_tpu_torch.pipeline import streamed_fit as tsf
from dmd_era5_tpu_torch.snapmat.loader import save_packed_matrix


def _lowrank(rng, s, t, rank, decay, noise):
    a = rng.standard_normal((s, rank))
    b = rng.standard_normal((rank, t))
    core = (a * np.logspace(0, -decay, rank)) @ b
    return (core + noise * rng.standard_normal((s, t))).astype(np.float32)


def _jax_omega(seed: int, t: int, k: int, n_oversamples=None) -> torch.Tensor:
    """The JAX package's range sketch (dmd_era5_tpu/ops/onepass.py:183-189)."""
    r = top.default_sketch_width(k, n_oversamples)
    key = jax.random.fold_in(jax.random.key(seed), 0x0E6A)
    return torch.from_numpy(np.array(jax.random.normal(key, (t, r), jnp.float32)))


def _port(t, k, seed, **kw):
    return top.OnePassSketch(t, k, seed=seed, device="cpu", omega=_jax_omega(seed, t, k), **kw)


def _subspace_gap(u_est, u_ref):
    qa, _ = np.linalg.qr(np.asarray(u_est, np.float64))
    qb, _ = np.linalg.qr(np.asarray(u_ref, np.float64))
    return 1.0 - np.linalg.svd(qa.T @ qb, compute_uv=False).min()


def _accumulators(sk):
    parts = sorted(sk._y_parts, key=lambda t: t[0])
    if isinstance(parts[0][1], torch.Tensor):
        y = torch.cat([p for _, p in parts]).numpy()
        return y, sk.w.numpy(), sk.g.numpy()
    y = np.concatenate([np.asarray(p) for _, p in parts])
    return y, np.asarray(sk.w), np.asarray(sk.g)


def _no_launch():
    return (tmatmul.matmul.launches, tmatmul.project.launches, tqr.gram.launches["highest"])


@pytest.mark.parametrize("seed,row_offset,n_rows,l_sketch", [
    (0, 0, 64, 32), (5, 128, 63, 17), (9, 65_537, 101, 256), (123_456_789, 2**31 + 7, 65, 40),
    (2**32 - 1, 2**32 - 10, 40, 9), (7, 2**31, 33, 8), (3, 2**32 - 1, 5, 3),
])
def test_psi_panel_bit_for_bit(seed, row_offset, n_rows, l_sketch):
    """The (n_rows, l) panel is the JAX (l, n_rows) panel transposed, bit
    for bit, at odd offsets and past 2^31 (uint32 wraparound past 2^32).
    The JAX jit parses Python ints as int32, so it takes numpy uint32."""
    ref = np.asarray(jop.psi_panel(np.uint32(seed), np.uint32(row_offset), n_rows, l_sketch))
    got = top.psi_panel(seed, row_offset, n_rows, l_sketch)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_rows, l_sketch)
    np.testing.assert_array_equal(got.numpy(), ref.T)
    assert set(np.unique(got.numpy())) <= {-1.0, 1.0}


def test_psi_panel_blocking_invariant():
    """Row blocks of the panel are the whole panel's rows."""
    whole = top.psi_panel(4, 1000, 96, 12)
    parts = torch.cat([top.psi_panel(4, 1000 + r0, 32, 12) for r0 in (0, 32, 64)])
    assert torch.equal(whole, parts)
    assert not torch.equal(whole, top.psi_panel(4, 0, 96, 12))


@pytest.mark.parametrize("center", [False, True])
def test_block_update_matches_jax(rng, center):
    """One block into zero sums: Y, W and G against the JAX block update
    (rtol 1e-5, atol 1e-5 of max, test_17's accumulator tolerance)."""
    x = _lowrank(rng, 200, 48, 6, 1, 1e-3) + rng.standard_normal((200, 1)).astype(np.float32)
    omega = _jax_omega(1, 48, 4)
    psi_t = top.psi_panel(1, 300, 200, 2 * omega.shape[1])
    w = torch.zeros((psi_t.shape[1], 48), dtype=torch.float64)
    g = torch.zeros((omega.shape[1],) * 2, dtype=torch.float64)
    before = _no_launch()
    y = top._block_update(w, g, torch.from_numpy(x), omega, psi_t, center=center)
    assert _no_launch() == before
    w_j, g_j, y_j = jop._block_update(
        jnp.zeros(tuple(w.shape), jnp.float32), jnp.zeros(tuple(g.shape), jnp.float32),
        jnp.asarray(x), jnp.asarray(omega.numpy()), jnp.asarray(psi_t.numpy().T), center=center)
    for got, ref, name in ((y.numpy(), y_j, "y"), (w.numpy(), w_j, "w"), (g.numpy(), g_j, "g")):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=name)


@pytest.mark.parametrize("order", [(0, 128, 256, 384), (384, 0, 256, 128)])
def test_sketch_blocked_matches_single_shot_and_jax(rng, order):
    """test_17:158-215: row-blocked accumulation in any order equals the
    whole-matrix call, and both equal the JAX sketches (rtol 1e-5, atol
    1e-5 of max); s agree with the JAX package's within test_17's 2e-2.
    G is near rank-deficient here (rank 12 under r = 16): the JAX
    package's f32 Cholesky takes its ridge and reads s ~4e-3 off numpy's,
    the port's f64 core within 1e-4, to which it is held."""
    x = _lowrank(rng, 512, 64, rank=12, decay=1, noise=1e-4)
    whole = _port(64, 6, seed=7)
    whole.update(0, x)
    blocked = _port(64, 6, seed=7)
    for r0 in order:
        blocked.update(r0, torch.from_numpy(x[r0:r0 + 128]))
    ref = jop.OnePassSketch(64, 6, seed=7)
    ref.update(0, jnp.asarray(x))
    for a, b, c, name in zip(_accumulators(whole), _accumulators(blocked), _accumulators(ref),
                             "ywg"):
        for got in (a, b):
            np.testing.assert_allclose(got, c, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(c).max()),
                                       err_msg=name)
    s_ref = np.asarray(ref.finalize().s)
    s_np = np.linalg.svd(x, compute_uv=False)[:6]
    for sk in (whole, blocked):
        s = sk.finalize().s.numpy()
        np.testing.assert_allclose(s, s_ref, rtol=2e-2)
        np.testing.assert_allclose(s, s_np, rtol=1e-4)


def test_onepass_core_matches_jax(rng):
    """The core solve on the JAX package's own (W, G): s, V and the U lift
    within 1e-4 relative, the error estimate within 1e-3 (the JAX core
    solves in f32, the port's in f64)."""
    x = _lowrank(rng, 1024, 96, rank=8, decay=1, noise=1e-3)
    ref = jop.OnePassSketch(96, 8, seed=3)
    ref.update(0, jnp.asarray(x))
    w, g, omega = np.array(ref.w), np.array(ref.g), np.array(ref.omega)
    lift, s, vt, est = top.onepass_core(torch.from_numpy(w), torch.from_numpy(g),
                                        torch.from_numpy(omega), 8)
    lift_j, s_j, vt_j, est_j = jop.onepass_core(ref.w, ref.g, ref.omega, 8)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vt_j), atol=1e-4)
    y = np.concatenate([np.asarray(p) for _, p in ref._y_parts])
    u, u_j = y @ lift.numpy(), y @ np.asarray(lift_j)
    np.testing.assert_allclose(u, u_j, atol=1e-4 * np.abs(u_j).max())
    assert float(est) == pytest.approx(float(est_j), rel=1e-3)


def _rank12():
    """A rank-12 X (5000 x 64), s ~5600 down to ~1100 in its leading 8."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((5000, 12)) * np.geomspace(10, 1, 12)
    return (a @ rng.standard_normal((12, 64))).astype(np.float32)


def _exact_sums(x: np.ndarray, sk) -> tuple[torch.Tensor, torch.Tensor]:
    """W = Psi^T X and G = (X Omega)^T (X Omega) in f64 from the stored X."""
    x64 = torch.from_numpy(x).double()
    psi = top.psi_panel(sk.seed, 0, x.shape[0], sk.l_sketch).double()
    y64 = x64 @ sk.omega.double()
    return psi.T @ x64, y64.T @ y64


def _factors_tight(g: torch.Tensor) -> bool:
    """G + 1e-7 mean(diag G) I factors: the core's first (tight) ridge."""
    eye = torch.eye(g.shape[0], dtype=torch.float64)
    return int(torch.linalg.cholesky_ex(g + 1e-7 * g.diagonal().mean() * eye).info) == 0


def test_onepass_rank_deficient_takes_the_fallback_ridge():
    """A rank-12 X at k = 8 under r = 18, in 5 blocks, JAX's Omega (seed
    1): six of G's eigenvalues are the f32 block Grams' rounding, the
    tight ridge does not factor the port's G, and the core falls back to
    1e-3 of its mean diagonal (utils.linalg.safe_cholesky, as the JAX
    package's).  The sums are right (W and G within 1e-6 of max of the
    f64 sums of the stored X), the f64 sums factor under the tight ridge
    and through the core give s within 1e-4 of numpy's: what the fallback
    costs is the core's.  The port's and the JAX package's s each held to
    numpy's at test_17's tolerances (leading 6 within 2e-2, all 8 within
    1e-1)."""
    x = _rank12()
    port = _port(64, 8, seed=1)
    ref = jop.OnePassSketch(64, 8, seed=1)
    for r0 in range(0, 5000, 1000):
        port.update(r0, torch.from_numpy(x[r0:r0 + 1000]))
        ref.update(r0, jnp.asarray(x[r0:r0 + 1000]))
    w64, g64 = _exact_sums(x, port)
    for got, want in ((port.w, w64), (port.g, g64)):
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert not _factors_tight(port.g) and _factors_tight(g64)
    s_np = np.linalg.svd(x.astype(np.float64), compute_uv=False)[:8]
    _, s_exact, _, _ = top.onepass_core(w64, g64, port.omega, 8)
    np.testing.assert_allclose(s_exact.numpy(), s_np, rtol=1e-4)
    for s in (port.finalize().s.numpy(), np.asarray(ref.finalize().s)):
        np.testing.assert_allclose(s[:6], s_np[:6], rtol=2e-2)
        np.testing.assert_allclose(s, s_np, rtol=1e-1)


def test_onepass_recovers_dominant_subspace(rng):
    """test_17:33: subspace gap < 1e-3, s[:6] rtol 2e-2, s rtol 1e-1 of
    numpy's; against the JAX result with the same Omega, s within
    test_17's 2e-2 (they read ~2e-4 apart: f64 against f32 core)."""
    x = _lowrank(rng, 1024, 96, rank=8, decay=1, noise=1e-4)
    res = top.onepass_svd(torch.from_numpy(x), 8, seed=3, omega=_jax_omega(3, 96, 8))
    u_np, s_np, _ = np.linalg.svd(x, full_matrices=False)
    assert isinstance(res.U, torch.Tensor) and res.U.device.type == "cpu"
    assert _subspace_gap(res.U.numpy(), u_np[:, :8]) < 1e-3
    np.testing.assert_allclose(res.s.numpy()[:6], s_np[:6], rtol=2e-2)
    np.testing.assert_allclose(res.s.numpy(), s_np[:8], rtol=1e-1)
    ref = jop.onepass_svd(jnp.asarray(x), 8, seed=3)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=2e-2)


def test_onepass_reconstruction_within_constant_of_optimal(rng):
    """test_17:47: ||X - U S V||_F <= 1.6 x the optimal rank-10 error."""
    x = _lowrank(rng, 2048, 128, rank=40, decay=2, noise=1e-3)
    res = top.onepass_svd(torch.from_numpy(x), 10, seed=0, omega=_jax_omega(0, 128, 10))
    approx = (res.U.numpy() * res.s.numpy()[None, :]) @ res.V.numpy()
    s_np = np.linalg.svd(x, compute_uv=False)
    assert np.linalg.norm(x - approx) <= 1.6 * np.linalg.norm(s_np[10:])


@pytest.mark.parametrize("decay,noise,k", [(2, 1e-3, 10), (0.5, 0.3, 10)])
def test_onepass_error_estimate_brackets_truth(rng, decay, noise, k):
    """test_17:70: 0.5 x true <= tail_rel_err_est <= 3 x true, and the
    estimate within 1e-3 relative of the JAX package's."""
    x = _lowrank(rng, 2048, 128, rank=40, decay=decay, noise=noise)
    sk = _port(128, k, seed=1)
    sk.update(0, x)
    res = sk.finalize()
    est = sk.tail_rel_err_est
    approx = (res.U.numpy() * res.s.numpy()[None, :]) @ res.V.numpy()
    true_rel = np.linalg.norm(x - approx) / np.linalg.norm(x)
    assert 0.5 * true_rel <= est <= 3.0 * max(true_rel, 1e-7), (est, true_rel)
    ref = jop.OnePassSketch(128, k, seed=1)
    ref.update(0, jnp.asarray(x))
    ref.finalize()
    assert est == pytest.approx(ref.tail_rel_err_est, rel=1e-3)


def test_onepass_centered_matches_centered_oracle(rng):
    """test_17:218: centred sketch against numpy's SVD of the row-centred
    X (subspace gap < 1e-3, s rtol 2e-2) and the JAX result (s 2e-2)."""
    x = _lowrank(rng, 512, 64, rank=8, decay=1, noise=1e-4)
    x = x + rng.standard_normal((512, 1)).astype(np.float32)
    res = top.onepass_svd(x, 6, seed=2, center=True, device="cpu", omega=_jax_omega(2, 64, 6))
    xc = x - x.mean(axis=1, keepdims=True)
    u_np, s_np, _ = np.linalg.svd(xc, full_matrices=False)
    assert _subspace_gap(res.U.numpy(), u_np[:, :6]) < 1e-3
    np.testing.assert_allclose(res.s.numpy(), s_np[:6], rtol=2e-2)
    ref = jop.onepass_svd(jnp.asarray(x), 6, seed=2, center=True)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=2e-2)


def test_y_store_host_equals_device(rng):
    """y_store="host": Y kept on the host and U lifted block by block,
    the same U as the device store's (atol 1e-6 of max|U|)."""
    x = _lowrank(rng, 300, 40, rank=6, decay=1, noise=1e-3)
    out = {}
    for store in ("device", "host"):
        sk = _port(40, 5, seed=4, y_store=store)
        for r0 in (200, 0, 100):
            sk.update(r0, x[r0:r0 + 100])
        out[store] = sk.finalize()
    assert isinstance(out["host"].U, np.ndarray) and out["host"].U.dtype == np.float32
    u_dev = out["device"].U.numpy()
    np.testing.assert_allclose(out["host"].U, u_dev, atol=1e-6 * np.abs(u_dev).max())
    with pytest.raises(ValueError, match="y_store"):
        top.OnePassSketch(40, 5, device="cpu", y_store="disk")


def test_onepass_empty_raises():
    sk = top.OnePassSketch(16, 2, device="cpu")
    with pytest.raises(ValueError, match="No blocks"):
        sk.finalize()


def test_onepass_needs_a_card_unless_told_otherwise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((32, 8), np.float32)
    np.save(tmp_path / "x.npy", x)
    with pytest.raises(RuntimeError, match="CUDA card"):
        top.OnePassSketch(8, 2)
    with pytest.raises(RuntimeError, match="CUDA card"):
        top.onepass_svd(x, 2)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tsf.streamed_onepass_svd(tmp_path / "x.npy", 2)
    assert top.onepass_svd(torch.from_numpy(x), 2).U.device.type == "cpu"


@pytest.mark.parametrize("suffix", [".npy", ".h5"])
def test_streamed_onepass_single_disk_pass(tmp_path, rng, monkeypatch, suffix):
    """test_17:283: one pass over the file (4 reads of 150 rows), equal
    to the in-memory one-pass (test_17: s rtol 1e-4) and to the JAX
    package's streamed result on the same file (s rtol 1e-4, U up to
    1e-4 of max)."""
    x = _lowrank(rng, 600, 48, rank=10, decay=1, noise=1e-4)
    path = tmp_path / f"packed{suffix}"
    save_packed_matrix(path, x)
    reads = []
    real_read = tsf.read_packed_rows

    def counting_read(p, r0, r1):
        reads.append((r0, r1))
        return real_read(p, r0, r1)

    monkeypatch.setattr(tsf, "read_packed_rows", counting_read)
    omega = _jax_omega(9, 48, 6)
    before = _no_launch()
    res = tsf.streamed_onepass_svd_core(path, omega, 6, block_rows=150, seed=9, device="cpu")
    assert len(reads) == 4 and _no_launch() == before
    assert isinstance(res.U, np.ndarray) and res.U.shape == (600, 6)
    ref = top.onepass_svd(torch.from_numpy(x), 6, seed=9, block_rows=150, omega=omega)
    np.testing.assert_allclose(res.s.numpy(), ref.s.numpy(), rtol=1e-4)
    if suffix == ".h5":
        ref_j = jsf.streamed_onepass_svd(path, 6, block_rows=150, seed=9)
        np.testing.assert_allclose(res.s.numpy(), np.asarray(ref_j.s), rtol=1e-4)
        u_j = np.asarray(ref_j.U)
        np.testing.assert_allclose(res.U, u_j, atol=1e-4 * np.abs(u_j).max())


@pytest.mark.parametrize("suffix", [".npy", ".h5"])
def test_streamed_onepass_bf16_packed(tmp_path, rng, suffix):
    """test_17:312: a bf16 artifact is decoded, not streamed as integer
    bits: s within 5e-2 of numpy's on the f32 matrix."""
    s_rows, t_cols, k = 512, 96, 8
    u = np.linalg.qr(rng.standard_normal((s_rows, k)))[0]
    v = np.linalg.qr(rng.standard_normal((t_cols, k)))[0]
    x = ((u * np.linspace(50, 10, k)) @ v.T
         + 0.01 * rng.standard_normal((s_rows, t_cols))).astype(np.float32)
    path = tmp_path / f"bf16{suffix}"
    save_packed_matrix(path, x, bf16=True)
    res = tsf.streamed_onepass_svd(path, k, block_rows=128, device="cpu")
    s_ref = np.linalg.svd(x, compute_uv=False)[:k]
    np.testing.assert_allclose(res.s.numpy(), s_ref, rtol=0.05)


def test_streamed_onepass_stamps_estimate_and_warns(tmp_path, rng, caplog, capsys):
    """test_17:89: ``info`` carries onepass_tail_rel_err_est; past 0.1 a
    warning is logged (and printed), on a clean spectrum none; the
    estimates within 1e-2 relative of the JAX package's on the same files
    (its f32 core reads 0.4% off the port's f64 one on the noisy file)."""
    cases = ((_lowrank(rng, 1024, 64, rank=40, decay=0.3, noise=0.5), 32, True),
             (_lowrank(rng, 1024, 64, rank=8, decay=1, noise=1e-5), 8, False))
    for i, (x, k, warns) in enumerate(cases):
        path = tmp_path / f"x{i}.h5"
        save_packed_matrix(path, x)
        info, info_j = {}, {}
        caplog.clear()
        capsys.readouterr()
        with caplog.at_level(logging.WARNING, logger="StreamedFit-torch"):
            tsf.streamed_onepass_svd_core(path, _jax_omega(0, 64, k), k, block_rows=256,
                                          device="cpu", info=info)
        est = info["onepass_tail_rel_err_est"]
        assert (est > 0.1) == warns
        warned = [r for r in caplog.records if "posterior error estimate" in r.message]
        assert bool(warned) == warns
        assert ("posterior error estimate" in capsys.readouterr().out) == warns
        jsf.streamed_onepass_svd(path, k, block_rows=256, info=info_j)
        assert est == pytest.approx(info_j["onepass_tail_rel_err_est"], rel=1e-2)


def test_jax_packed_artifact_streams_through_the_port(tmp_path, rng):
    """An artifact the JAX package writes (with coordinates) streams
    through the port's one-pass route as through the JAX one."""
    from dmd_era5_tpu.snapmat import create_mock_era5

    x = _lowrank(rng, 400, 48, rank=6, decay=1, noise=1e-4)
    fs = create_mock_era5("2020-01-01", "2020-01-02", ["temperature"], [1000], seed=0)
    _, meta = jloader.build_snapshot_matrix(fs)
    path = tmp_path / "packed.h5"
    jloader.save_packed_snapshot(path, x, meta)
    res = tsf.streamed_onepass_svd_core(path, _jax_omega(2, 48, 5), 5, block_rows=100, seed=2,
                                        device="cpu")
    ref = jsf.streamed_onepass_svd(path, 5, block_rows=100, seed=2)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-4)
