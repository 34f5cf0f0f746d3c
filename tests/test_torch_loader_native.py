"""Parity of the port's packer and the loader's FieldSet half with the JAX
package's.

tests/test_09_loader_native.py:26-86 case by case: ``pack_space_time``
(f32 and bf16 words), the f32 -> bf16 rounding, ``row_stats``,
``build_snapshot_matrix`` against ``flatten_era5_variables`` and against
the JAX function on the same FieldSet, and packed HDF5 files written by
either package and read by the other.  The packer's words and the packed
matrices agree bit for bit with the JAX package's C++ packer.  The mesh
cases (:88-115) come with the distributed layer.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from dmd_era5_tpu import native as jnative
from dmd_era5_tpu.snapmat import create_mock_era5 as mock_jax
from dmd_era5_tpu.snapmat import loader as jloader
from dmd_era5_tpu_torch import native
from dmd_era5_tpu_torch.snapmat import create_mock_era5, flatten_era5_variables
from dmd_era5_tpu_torch.snapmat import loader as tloader


def _bf16_back(words: np.ndarray) -> np.ndarray:
    return torch.from_numpy(words.view(np.int16)).view(torch.bfloat16).float().numpy()


def test_packer_is_one_implementation_with_no_build():
    """No library to build or load and no fallback to choose: the port's
    packer is torch on the host."""
    assert not hasattr(native, "native_available")
    assert not any(p.suffix in (".so", ".cpp") for p in Path(native.__file__).parent.iterdir())


@pytest.mark.parametrize("shape", [(37, 101), (1, 5), (130, 70)])
def test_pack_space_time_matches_transpose(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    out = native.pack_space_time(x)
    assert out.dtype == np.float32 and out.flags.c_contiguous
    np.testing.assert_array_equal(out, x.T)
    assert out.tobytes() == jnative.pack_space_time(x).tobytes()


def test_pack_space_time_bf16(rng):
    x = rng.standard_normal((16, 64)).astype(np.float32)
    out16 = native.pack_space_time(x, bf16=True)
    assert out16.dtype == np.uint16 and out16.shape == (64, 16)
    assert out16.tobytes() == jnative.pack_space_time(x, bf16=True).tobytes()
    np.testing.assert_allclose(_bf16_back(out16), x.T, rtol=1e-2, atol=1e-2)


def test_bf16_round_to_nearest_even():
    vals = np.array([1.0, 1.0039062, -2.5, 3.1415926, 1e-38], dtype=np.float32)
    words = native.to_bf16_words(vals)
    np.testing.assert_allclose(_bf16_back(words), vals, rtol=8e-3, atol=1e-39)
    assert words.tobytes() == jnative.to_bf16_words(vals).tobytes()


def test_bf16_words_bit_equal_to_the_cpp_packer_on_finite_values_and_the_fill_nan():
    """Ties both ways, values rounding into the next binade, subnormals,
    signed zeros, the largest finite values, infinities, and the
    canonical quiet NaN of a missing chunk's fill: the C++ packer's words
    bit for bit, shape kept."""
    ties = [1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 1 + 2**-8 + 2**-20, 1.9921875 + 2**-8]
    edges = [0.0, -0.0, 1e-40, -1e-40, 2**-126, 3.4e38, -3.4e38, np.finfo(np.float32).max,
             np.finfo(np.float32).tiny, np.inf, -np.inf, np.nan]
    rnd = np.random.default_rng(5).standard_normal(983) * 1e3
    x = np.concatenate([ties, edges, rnd]).astype(np.float32).reshape(-1, 10)
    assert x.view(np.uint32)[np.isnan(x)].tolist() == [0x7FC00000]
    got = native.to_bf16_words(x)
    assert got.shape == x.shape and got.tobytes() == jnative.to_bf16_words(x).tobytes()
    assert native.pack_space_time(x, bf16=True).tobytes() == \
        jnative.pack_space_time(x, bf16=True).tobytes()


def test_nan_payloads_stay_nan_where_the_cpp_packer_overflows_them():
    """The documented difference: a NaN with low payload bits set keeps
    the canonical NaN word here, while the packer's integer rounding
    carries the payload into the exponent (an infinity or a wrapped
    word)."""
    bits = np.array([0x7F800001, 0x7FFFFFFF, 0xFFC00001], dtype=np.uint32)
    x = bits.view(np.float32)
    assert native.to_bf16_words(x).tolist() == [0x7FC0] * 3
    assert jnative.to_bf16_words(x).tolist() == [0x7F80, 0x8000, 0xFFC0]


def test_row_stats(rng):
    x = rng.standard_normal((50, 333)).astype(np.float32) + 3.0
    for ddof in (0, 1):
        mean, std = native.row_stats(x, ddof=ddof)
        assert mean.dtype == std.dtype == np.float32
        np.testing.assert_allclose(mean, x.mean(axis=1), atol=1e-5)
        np.testing.assert_allclose(std, x.std(axis=1, ddof=ddof), atol=1e-5)
        mean_j, std_j = jnative.row_stats(x, ddof=ddof)
        np.testing.assert_allclose(mean, mean_j, rtol=1e-7)
        np.testing.assert_allclose(std, std_j, rtol=1e-6)
    # one column, ddof 1: no spread to estimate, 0 as in the packer
    assert native.row_stats(x[:, :1], ddof=1)[1].tolist() == [0.0] * 50
    m, s = tloader.host_row_stats(x)
    np.testing.assert_array_equal(m, native.row_stats(x)[0])
    np.testing.assert_array_equal(s, native.row_stats(x)[1])


@pytest.mark.parametrize("bf16", [False, True])
def test_build_snapshot_matrix_matches_flatten(bf16):
    args = ("2020-01-01", "2020-01-01T06", ["temperature", "u_component_of_wind"], [1000, 850])
    fs = create_mock_era5(*args, seed=9)
    x, meta = tloader.build_snapshot_matrix(fs, bf16=bf16)
    if not bf16:
        np.testing.assert_array_equal(x, np.asarray(flatten_era5_variables(fs).data, np.float32))
    assert meta.n_rows == x.shape[0] and meta.n_space_per_var == 2 * 36 * 72
    assert meta.variables == ["temperature", "u_component_of_wind"]
    x_j, meta_j = jloader.build_snapshot_matrix(mock_jax(*args, seed=9), bf16=bf16)
    assert x.dtype == x_j.dtype and x.tobytes() == x_j.tobytes()
    for name in ("levels", "latitudes", "longitudes", "times"):
        np.testing.assert_array_equal(getattr(meta, name), getattr(meta_j, name))
    # one variable in a given order
    x_u, _ = tloader.build_snapshot_matrix(fs, ["u_component_of_wind"], bf16=bf16)
    assert x_u.tobytes() == x[meta.n_space_per_var:].tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("bf16", [False, True])
def test_packed_roundtrip(tmp_path, writer, bf16):
    """A packed HDF5 file with coordinates written by either package reads
    back in both: the same shape, bf16 flag, meta and rows."""
    fs = create_mock_era5("2020-01-01", "2020-01-01T04", ["temperature"], [1000], seed=1)
    x, meta = tloader.build_snapshot_matrix(fs, bf16=bf16)
    path = tmp_path / "packed.h5"
    {"jax": jloader, "port": tloader}[writer].save_packed_snapshot(path, x, meta)
    for reader in (tloader, jloader):
        shape, meta2, flag = reader.packed_info(path)
        assert shape == x.shape and flag == bf16
        assert meta2.variables == ["temperature"]
        np.testing.assert_array_equal(reader.read_packed_rows(path, 10, 20), x[10:20])
        for name in ("levels", "latitudes", "longitudes", "times"):
            np.testing.assert_array_equal(getattr(meta2, name), getattr(meta, name))


def test_packed_snapshot_npy_holds_x_alone(tmp_path):
    fs = create_mock_era5("2020-01-01", "2020-01-01T04", ["temperature"], [1000], seed=1)
    x, meta = tloader.build_snapshot_matrix(fs)
    path = tmp_path / "packed.npy"
    tloader.save_packed_snapshot(path, x, meta)
    shape, meta2, bf16 = tloader.packed_info(path)
    assert shape == x.shape and not bf16 and meta2.variables == [] and meta2.n_rows == 0
    np.testing.assert_array_equal(tloader.read_packed_rows(path, 0, shape[0]), x)
    assert tloader.packed_info(x)[1].variables == []
