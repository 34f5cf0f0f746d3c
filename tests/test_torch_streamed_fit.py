"""Parity of the port's out-of-core SVD and packed artifact with the JAX
package.

The cases of ``tests/test_10_streaming.py:99-340`` on the same files:
artifacts written by the JAX package are streamed by both packages.
The port's randomized core takes the JAX package's own sketch,
``jax.random.normal(jax.random.key(seed), (T, r))``, so both run the
same iterates; its kernels take their plain PyTorch versions on the
CPU.  Tolerances are that file's (s rtol 1e-3, U atol 2e-3) or tighter.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.pipeline import streamed_fit as jsf
from dmd_era5_tpu.snapmat import create_mock_era5
from dmd_era5_tpu.snapmat import loader as jloader
from dmd_era5_tpu_torch.ops import matmul as tmatmul
from dmd_era5_tpu_torch.ops import qr_panel as tqr
from dmd_era5_tpu_torch.pipeline import streamed_fit as tsf
from dmd_era5_tpu_torch.snapmat import loader as tloader

ROOT = Path(__file__).resolve().parents[1]


def _lowrank(rng, s, t, rank, noise):
    return (
        rng.standard_normal((s, rank)) @ rng.standard_normal((rank, t))
        + noise * rng.standard_normal((s, t))
    ).astype(np.float32)


def _jax_omega(seed: int, t: int, r: int) -> torch.Tensor:
    """The sketch the JAX package draws (streamed_fit.py:151-154)."""
    return torch.from_numpy(
        np.array(jax.random.normal(jax.random.key(seed), (t, r), jnp.float32))
    )


def _port(path, k, seed, n_oversamples=10, col_limit=None, **kw):
    t = tloader.packed_info(path)[0][1] if col_limit is None else col_limit
    return tsf.streamed_randomized_svd_core(
        path, _jax_omega(seed, t, k + n_oversamples), k, device="cpu",
        col_limit=col_limit, **kw,
    )


def _packed_snapshot(tmp_path, x, name):
    """An HDF5 artifact with coordinates, as the JAX tests write it."""
    fs = create_mock_era5("2020-01-01", "2020-01-02", ["temperature"], [1000], seed=0)
    _, meta = jloader.build_snapshot_matrix(fs)
    path = tmp_path / name
    jloader.save_packed_snapshot(path, x, meta)
    return path


def test_streamed_randomized_svd_matches_jax(tmp_path, rng):
    """test_10_streaming.py:99-123: the same file through both packages,
    and the in-memory randomized SVD to that file's tolerances."""
    from dmd_era5_tpu.ops.svd import randomized_svd

    s, t, k = 1000, 64, 6
    x = _lowrank(rng, s, t, 10, 1e-3)
    path = _packed_snapshot(tmp_path, x, "packed.h5")
    before = (tmatmul.matmul.launches, tqr.householder_panel.launches)
    res = _port(path, k, seed=4, block_rows=128)
    assert (tmatmul.matmul.launches, tqr.householder_panel.launches) == before == (0, 0)
    ref = jsf.streamed_randomized_svd(path, k, block_rows=128, seed=4)
    u = res.U
    assert isinstance(u, np.ndarray) and u.dtype == np.float32 and u.shape == (s, k)
    assert res.s.shape == (k,) and res.V.shape == (k, t)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-5)
    np.testing.assert_allclose(u, np.asarray(ref.U), atol=1e-4)
    np.testing.assert_allclose(res.V.numpy(), np.asarray(ref.V), atol=1e-4)
    mem = randomized_svd(jnp.asarray(x), k, seed=4)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(mem.s), rtol=1e-3)
    np.testing.assert_allclose(u, np.asarray(mem.U), atol=2e-3)


@pytest.mark.parametrize("n_iter", [0, 1, 3])
def test_streamed_power_iteration_pass_count(tmp_path, rng, n_iter, monkeypatch):
    """test_10_streaming.py:126-153: n_iter + 2 passes over the file,
    counted at prefetched_row_blocks, and one Householder leaf after each
    of the n_iter fused passes (K7's schedule on the card)."""
    x = rng.standard_normal((512, 32)).astype(np.float32)
    path = _packed_snapshot(tmp_path, x, "pc.h5")
    passes, leaves = [], []
    orig_blocks, orig_leaf = tsf.prefetched_row_blocks, tsf._local_factor

    def counting_blocks(p, n_rows, block_rows, depth=2):
        passes.append(1)
        return orig_blocks(p, n_rows, block_rows, depth)

    def counting_leaf(z, method):
        leaves.append((tuple(z.shape), method))
        return orig_leaf(z, method)

    monkeypatch.setattr(tsf, "prefetched_row_blocks", counting_blocks)
    monkeypatch.setattr(tsf, "_local_factor", counting_leaf)
    tsf.streamed_randomized_svd(path, 4, block_rows=128, seed=1, n_iter=n_iter, device="cpu")
    assert len(passes) == n_iter + 2
    assert leaves == [((32, 14), "householder")] * n_iter


def test_streamed_bf16_blocks(tmp_path, rng):
    """test_10_streaming.py:156-178: a bf16 artifact streams as bf16
    blocks (the iterate rounded to bf16 before each sketch, as in the JAX
    package); the port follows the JAX route, and both hold the f32
    in-memory factorization to that file's tolerances."""
    from dmd_era5_tpu.ops.svd import randomized_svd

    s, t, k = 1024, 48, 5
    x = _lowrank(rng, s, t, 8, 1e-3)
    path = tmp_path / "bf16.h5"
    jloader.save_packed_matrix(path, x, d=1, bf16=True)
    res = _port(path, k, seed=2, block_rows=256)
    ref = jsf.streamed_randomized_svd(path, k, block_rows=256, seed=2)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-3)
    np.testing.assert_allclose(res.U, np.asarray(ref.U), atol=2e-3)
    mem = randomized_svd(jnp.asarray(x), k, seed=2)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(mem.s), rtol=2e-2)
    sv = np.linalg.svd(res.U.T @ np.asarray(mem.U), compute_uv=False)
    assert sv.min() > 0.99


def test_streamed_u_wire_dtype_and_u_out(tmp_path, rng):
    """test_10_streaming.py:181-221: the bf16 wire by default on a bf16
    artifact, a forced f32 wire, U written into an h5py dataset and into
    a .npy memmap, and a bad ``u_dtype`` refused; the auto U against the
    JAX package's."""
    s, t, k = 1024, 48, 5
    x = _lowrank(rng, s, t, 8, 1e-3)
    path = tmp_path / "bf16.h5"
    jloader.save_packed_matrix(path, x, d=1, bf16=True)

    res_auto = _port(path, k, seed=2, block_rows=256)
    res_f32 = _port(path, k, seed=2, block_rows=256, u_dtype="float32")
    u_auto, u_f32 = res_auto.U, res_f32.U
    assert u_auto.dtype == np.float32 and u_f32.dtype == np.float32
    assert np.max(np.abs(u_auto - u_f32)) < 1e-2
    sv = np.linalg.svd(u_auto.T @ u_f32, compute_uv=False)
    assert sv.min() > 0.995
    # the wire only rounds U's values: every entry is a bf16 value
    assert np.array_equal(u_auto, torch.from_numpy(u_auto).bfloat16().float().numpy())
    ref = jsf.streamed_randomized_svd(path, k, block_rows=256, seed=2)
    np.testing.assert_allclose(u_auto, np.asarray(ref.U), atol=2e-3)

    with h5py.File(tmp_path / "u.h5", "w") as f:
        dset = f.create_dataset("U", shape=(s, k), dtype=np.float32)
        res_out = _port(path, k, seed=2, block_rows=256, u_out=dset)
        assert res_out.U is dset
        np.testing.assert_allclose(dset[:], u_auto, atol=1e-6)
    mm = np.lib.format.open_memmap(tmp_path / "u.npy", mode="w+", dtype=np.float32, shape=(s, k))
    assert _port(path, k, seed=2, block_rows=256, u_out=mm).U is mm
    np.testing.assert_allclose(np.asarray(mm), u_auto, atol=1e-6)

    with pytest.raises(ValueError, match="u_dtype"):
        tsf.streamed_randomized_svd(path, k, block_rows=256, u_dtype="int8", device="cpu")


def test_streamed_col_limit_matches_jax(tmp_path, rng):
    """test_10_streaming.py:224-244: col_limit decomposes X[:, :limit]."""
    s, t, k, lim = 800, 60, 5, 44
    x = _lowrank(rng, s, t, 8, 1e-3)
    path = tmp_path / "cl.h5"
    jloader.save_packed_matrix(path, x, d=1)
    res = _port(path, k, seed=3, block_rows=128, col_limit=lim)
    ref = jsf.streamed_randomized_svd(path, k, block_rows=128, seed=3, col_limit=lim)
    assert res.V.shape == (k, lim)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-3)
    np.testing.assert_allclose(res.U, np.asarray(ref.U), atol=2e-3)
    s_np = np.linalg.svd(x[:, :lim], compute_uv=False)[:k]
    np.testing.assert_allclose(res.s.numpy(), s_np, rtol=1e-3)
    with pytest.raises(ValueError, match="col_limit"):
        tsf.streamed_randomized_svd(path, k, col_limit=0, device="cpu")


def test_streamed_exact_gram_svd_matches_numpy_and_jax(tmp_path, rng):
    """test_10_streaming.py:247-301, host f64 accumulation: the resolved
    components oracle-exact, the noise floor at the floor, sklearn
    signs; the bf16 file with u_out and col_limit; and the JAX route."""
    s, t, k = 900, 56, 7
    x = _lowrank(rng, s, t, 6, 1e-4)
    path = tmp_path / "g.h5"
    jloader.save_packed_matrix(path, x, d=1)

    res = tsf.streamed_exact_gram_svd(path, k, block_rows=128, device="cpu")
    u, sv, v = res
    assert isinstance(u, np.ndarray) and sv.dtype == np.float32 and v.dtype == np.float32
    u_np, s_np, vt_np = np.linalg.svd(x, full_matrices=False)
    np.testing.assert_allclose(sv[:6], s_np[:6], rtol=1e-5)
    assert float(sv[6]) < 3e-4 * float(sv[0])
    np.testing.assert_allclose(np.abs(u[:, :6]), np.abs(u_np[:, :6]), atol=1e-4)
    np.testing.assert_allclose(np.abs(v[:6]), np.abs(vt_np[:6]), atol=1e-4)
    np.testing.assert_allclose((u * sv[None, :]) @ v, x, atol=2e-2)
    mx = np.argmax(np.abs(v), axis=1)
    assert (v[np.arange(k), mx] > 0).all()
    ref = jsf.streamed_exact_gram_svd(path, k, block_rows=128)
    np.testing.assert_allclose(sv[:6], np.asarray(ref.s)[:6], rtol=1e-5)
    np.testing.assert_allclose(u[:, :6], np.asarray(ref.U)[:, :6], atol=1e-4)
    np.testing.assert_allclose(v[:6], np.asarray(ref.V)[:6], atol=1e-4)

    path2 = tmp_path / "g16.h5"
    jloader.save_packed_matrix(path2, x, d=1, bf16=True)
    lim = 40
    u_buf = np.zeros((s, k), np.float32)
    res2 = tsf.streamed_exact_gram_svd(
        path2, k, block_rows=256, col_limit=lim, u_out=u_buf, device="cpu"
    )
    assert res2.U is u_buf and res2.V.shape == (k, lim)
    s_ref = np.linalg.svd(
        x[:, :lim].astype(jnp.bfloat16).astype(np.float32), compute_uv=False
    )[:k]
    np.testing.assert_allclose(res2.s[:6], s_ref[:6], rtol=2e-2)
    ref2 = jsf.streamed_exact_gram_svd(path2, k, block_rows=256, col_limit=lim)
    np.testing.assert_allclose(res2.s[:6], np.asarray(ref2.s)[:6], rtol=1e-5)
    np.testing.assert_allclose(u_buf[:, :6], np.asarray(ref2.U)[:, :6], atol=2e-3)


def test_streamed_exact_gram_wide_time_axis(tmp_path, rng):
    """test_10_streaming.py:304-322: past T^2 * 4 = 8 MB the Gram sums on
    the device in f32; against numpy and the JAX route."""
    s, t, k = 384, 1500, 5
    x = _lowrank(rng, s, t, 4, 1e-4)
    path = tmp_path / "wide.h5"
    jloader.save_packed_matrix(path, x, d=1)
    res = tsf.streamed_exact_gram_svd(path, k, block_rows=96, device="cpu")
    s_np = np.linalg.svd(x, compute_uv=False)
    np.testing.assert_allclose(res.s[:4], s_np[:4], rtol=1e-4)
    assert res.V.shape == (k, t)
    ref = jsf.streamed_exact_gram_svd(path, k, block_rows=96)
    np.testing.assert_allclose(res.s[:4], np.asarray(ref.s)[:4], rtol=1e-5)
    np.testing.assert_allclose(np.abs(res.V[:4]), np.abs(np.asarray(ref.V)[:4]), atol=1e-4)


@pytest.mark.parametrize("kind", ["h5", "npy", "ndarray", "memmap"])
def test_prefetched_row_blocks_order(tmp_path, rng, kind):
    """test_10_streaming.py:325-340, for each source the loader takes."""
    x = rng.standard_normal((100, 8)).astype(np.float32)
    if kind == "h5":
        source = _packed_snapshot(tmp_path, x, "p.h5")
    elif kind == "npy":
        source = tmp_path / "p.npy"
        np.save(source, x)
    elif kind == "memmap":
        np.save(tmp_path / "p.npy", x)
        source = np.load(tmp_path / "p.npy", mmap_mode="r")
    else:
        source = x
    blocks = list(tsf.prefetched_row_blocks(source, 100, 32))
    assert all(b[1].flags.writeable for b in blocks)
    assert [b[0] for b in blocks] == [0, 32, 64, 96]
    np.testing.assert_array_equal(np.concatenate([b[1] for b in blocks]), x)


def test_prefetched_row_blocks_raises_a_failed_read_and_stops_when_abandoned(monkeypatch, rng):
    """A read that fails in the reader thread raises in the consumer, so
    a pass never ends short; a consumer that stops early leaves no reader
    thread behind."""
    import threading

    x = rng.standard_normal((100, 8)).astype(np.float32)
    orig = tsf.read_packed_rows

    def failing(source, r0, r1):
        if r0 >= 64:
            raise OSError("disk gone")
        return orig(source, r0, r1)

    monkeypatch.setattr(tsf, "read_packed_rows", failing)
    got = []
    with pytest.raises(OSError, match="disk gone"):
        for r0, _ in tsf.prefetched_row_blocks(x, 100, 16):
            got.append(r0)
    assert got == [0, 16, 32, 48]
    monkeypatch.setattr(tsf, "read_packed_rows", orig)
    before = threading.active_count()
    blocks = tsf.prefetched_row_blocks(x, 100, 4, depth=2)
    assert next(blocks)[0] == 0
    blocks.close()
    assert threading.active_count() == before


# ------------------------------------------------------------ the artifact


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [1, 2])
def test_npy_and_h5_artifacts_read_alike(tmp_path, rng, bf16, d):
    """The port writes .npy and .h5 artifacts holding the JAX package's
    layout (delay slabs, uint16 bf16 bits): all three read alike, from a
    numpy array and from a tensor."""
    x = rng.standard_normal((300, 20)).astype(np.float32)
    jpath = tmp_path / "jax.h5"
    shape = jloader.save_packed_matrix(jpath, x, d=d, bf16=bf16)
    paths = [tmp_path / "port.npy", tmp_path / "port.h5"]
    for p, src in zip(paths, (x, torch.from_numpy(x))):
        assert tloader.save_packed_matrix(p, src, d=d, bf16=bf16) == shape
    want = jloader.read_packed_rows(jpath, 0, shape[0])
    assert want.dtype == (np.uint16 if bf16 else np.float32)
    for p in [jpath, *paths]:
        got_shape, meta, got_bf16 = tloader.packed_info(p)
        assert (got_shape, got_bf16) == (shape, bf16)
        assert meta.variables == jloader.packed_info(jpath)[1].variables == []
        np.testing.assert_array_equal(tloader.read_packed_rows(p, 0, shape[0]), want)
        np.testing.assert_array_equal(tloader.read_packed_rows(p, 37, 171), want[37:171])
    assert tloader.packed_info(want)[::2] == (shape, bf16)


def test_bf16_packing_bit_equal_to_jax(tmp_path):
    """The port's f32 -> bf16 conversion against the JAX package's
    packer, bit for bit, on finite values: round-to-nearest-even ties
    both ways, values that round up into the next binade, subnormals,
    signed zeros and the largest f32 values."""
    ties = np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 1 + 2**-8 + 2**-20], np.float32)
    edges = np.array([0.0, -0.0, 1e-40, -1e-40, 2**-126, 3.4e38, -3.4e38, 1.9921875 + 2**-8,
                      np.finfo(np.float32).max, np.finfo(np.float32).tiny], np.float32)
    rnd = np.random.default_rng(5).standard_normal(4000).astype(np.float32) * 1e3
    x = np.concatenate([ties, edges, rnd]).reshape(-1, 6)
    jpath, tpath = tmp_path / "j.h5", tmp_path / "t.npy"
    jloader.save_packed_matrix(jpath, x, bf16=True)
    tloader.save_packed_matrix(tpath, x, bf16=True)
    np.testing.assert_array_equal(np.load(tpath), jloader.read_packed_rows(jpath, 0, len(x)))


def test_streamed_npy_equals_h5(tmp_path, rng):
    """The same matrix as a .npy and an .h5 artifact, and in memory,
    gives the same decomposition bit for bit."""
    x = _lowrank(rng, 700, 40, 6, 1e-3)
    tloader.save_packed_matrix(tmp_path / "a.npy", x)
    tloader.save_packed_matrix(tmp_path / "a.h5", x)
    outs = [_port(src, 5, seed=1, block_rows=128)
            for src in (tmp_path / "a.npy", tmp_path / "a.h5", x)]
    for other in outs[1:]:
        assert np.array_equal(outs[0].U, other.U)
        assert torch.equal(outs[0].s, other.s)


def test_loader_imports_and_streams_without_h5py(tmp_path):
    """h5py is imported only where an HDF5 file is touched: with it
    blocked, the loader and the streamed SVD import and run on .npy."""
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "import numpy as np\n"
        "from dmd_era5_tpu_torch.snapmat import loader\n"
        "from dmd_era5_tpu_torch.pipeline import streamed_exact_gram_svd\n"
        f"p = {str(tmp_path / 'x.npy')!r}\n"
        "x = np.random.default_rng(0).standard_normal((200, 12)).astype(np.float32)\n"
        "assert loader.save_packed_matrix(p, x, bf16=True) == (200, 12)\n"
        "assert loader.packed_info(p)[::2] == ((200, 12), True)\n"
        "assert streamed_exact_gram_svd(p, 3, block_rows=64, device='cpu').U.shape == (200, 3)\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
