"""Parity of the port's profiling and debug utilities with the JAX
package's (``tests/test_12_observability.py:26-72``).

On the CPU both packages fall back to the same nominal peaks, so
``roofline`` and ``throughput`` return the same dicts for the same
inputs; ``tree_checksum`` gives the same digest of the same arrays.
``debug_nans`` is a dispatch mode here (JAX: the ``jax_debug_nans``
flag).  The mesh case (``test_12_observability.py:73``) waits for the
port's distributed layer.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmd_era5_tpu.utils import debug as debug_jax
from dmd_era5_tpu.utils import profiling as prof_jax
from dmd_era5_tpu_torch.ops.svd import exact_truncated_svd
from dmd_era5_tpu_torch.utils.debug import (
    assert_finite,
    check_deterministic,
    debug_nans,
    tree_checksum,
)
from dmd_era5_tpu_torch.utils.profiling import (
    DevicePeaks,
    device_peaks,
    measure,
    roofline,
    throughput,
    trace,
)


def test_measure_returns_positive_time():
    x = torch.ones((128, 128))
    assert measure(lambda a: a @ a.T, x, iters=3, warmup=1) > 0
    assert measure(lambda a: {"y": (a.sum(), a)}, x, iters=2, warmup=0) > 0


def test_device_peaks_on_the_cpu_match_jax():
    peaks, ref = device_peaks(), prof_jax.device_peaks()
    assert peaks.bf16_flops > 0 and peaks.hbm_bw > 0
    assert (peaks.name, peaks.bf16_flops, peaks.f32_flops, peaks.hbm_bw) == (
        ref.name, ref.bf16_flops, ref.f32_flops, ref.hbm_bw)
    assert device_peaks("cpu") == peaks
    h100 = DevicePeaks("H100 SXM", 989e12, 67e12, 3.35e12, 495e12)
    assert h100.tf32_flops == 495e12


@pytest.mark.parametrize("flops,nbytes,seconds,dtype,bound", [
    (1e12, 1e6, 1.0, "bf16", "compute"), (1e6, 1e12, 1.0, "bf16", "memory"),
    (3e9, 2e8, 0.01, "f32", "compute"),
])
def test_roofline_matches_jax(flops, nbytes, seconds, dtype, bound):
    """test_12:39: compute- and memory-bound classification, every field
    equal to the JAX package's on the CPU."""
    got = roofline(flops=flops, bytes_accessed=nbytes, seconds=seconds, dtype=dtype)
    assert got == prof_jax.roofline(flops=flops, bytes_accessed=nbytes, seconds=seconds,
                                    dtype=dtype)
    assert got["bound"] == bound


def test_throughput_counters():
    tp = throughput(2_000_000_000, 2.0)
    assert tp["gelements_per_s"] == 1.0
    assert tp == prof_jax.throughput(2_000_000_000, 2.0)


def test_trace_writes_a_chrome_trace(tmp_path):
    """The profiled scope's ops land in <log_dir>/trace.json."""
    with trace(tmp_path / "prof") as prof:
        with torch.profiler.record_function("scope"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "scope" in names and any("mm" in str(n) for n in names)
    assert any(e.key == "scope" for e in prof.key_averages())


def test_assert_finite_raises():
    assert_finite({"a": torch.ones(3), "b": [np.ones(2), (torch.zeros(1),)]})
    with pytest.raises(FloatingPointError, match=r"bad\['a'\] has 1 non-finite"):
        assert_finite({"a": torch.tensor([1.0, float("nan")])}, "bad")
    with pytest.raises(FloatingPointError, match=r"x\[1\]\[0\]"):
        assert_finite([torch.ones(2), (torch.tensor([float("inf")]),)], "x")


def test_debug_nans_context():
    """A NaN from any op raises inside the scope, not outside; finite
    work passes through unchanged."""
    with debug_nans():
        assert torch.equal(torch.ones(3) * 2, torch.full((3,), 2.0))
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.log(torch.tensor(-1.0))
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
    with debug_nans(enable=False):
        assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_tree_checksum_matches_jax():
    """test_12:63: sensitive to one entry, equal for equal trees, and the
    same digest as the JAX package's for the same arrays."""
    a = {"x": torch.ones((4, 4)), "y": [torch.arange(6.0).reshape(2, 3)]}
    b = {"x": torch.ones((4, 4)), "y": [torch.arange(6.0).reshape(2, 3)]}
    b["x"][0, 0] = 2.0
    assert tree_checksum(a) != tree_checksum(b)
    assert tree_checksum(a) == tree_checksum({"x": torch.ones((4, 4)),
                                              "y": [torch.arange(6.0).reshape(2, 3)]})
    ref = debug_jax.tree_checksum({"x": jnp.ones((4, 4)),
                                   "y": [jnp.arange(6.0).reshape(2, 3)]})
    assert tree_checksum(a) == ref


def test_check_deterministic():
    """A seeded SVD reruns bit for bit; an unseeded draw does not."""
    x = torch.randn(256, 32, generator=torch.Generator().manual_seed(0))
    assert check_deterministic(lambda: exact_truncated_svd(x, 4))
    assert not check_deterministic(lambda: torch.randn(8))
