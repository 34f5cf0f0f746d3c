"""Tracing, timing, and roofline counters.

PyTorch counterpart of ``dmd_era5_tpu/utils/profiling.py``: a profiler
trace (``torch.profiler`` with CPU and, where a card is present, CUDA
activities, written as a Chrome/Perfetto trace), steady-state timing,
and roofline utilization against the card's published peaks.

``measure`` synchronizes the device of the call's first tensor output.
The JAX module fetched one scalar instead, a workaround for a proxied
TPU backend whose ``block_until_ready`` did not wait; a CUDA device
synchronizes.  The peaks are NVIDIA's data-sheet figures for the H100
SXM (dense, without sparsity) at its full 700 W power limit: a card set
below that limit runs slower under load.  Any other device, the CPU
included, gets the JAX module's nominal fallback.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

__all__ = [
    "trace",
    "measure",
    "DevicePeaks",
    "device_peaks",
    "roofline",
    "throughput",
]


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the scope with ``torch.profiler`` and write the trace as
    ``<log_dir>/trace.json`` (Chrome/Perfetto format).  Yields the
    profiler, whose events and ``key_averages()`` the caller may read
    after the scope."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _first_tensor(value):
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for item in value:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def _sync(value) -> None:
    """Wait for the device that holds the result's first tensor."""
    leaf = _first_tensor(value)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def measure(
    fn: Callable,
    *args,
    iters: int = 5,
    warmup: int = 2,
) -> float:
    """Median steady-state seconds per call of ``fn(*args)``."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@dataclass(frozen=True)
class DevicePeaks:
    """Peak compute/bandwidth for roofline accounting; ``tf32_flops`` is
    the tensor cores' TF32 rate (the f32 rate where there is none)."""

    name: str
    bf16_flops: float  # FLOP/s
    f32_flops: float
    hbm_bw: float  # bytes/s
    tf32_flops: float = 0.0


# keyed on torch.cuda.get_device_name()
_PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks("H100 SXM", 989e12, 67e12, 3.35e12, 495e12),
}
_CPU_FALLBACK = DevicePeaks("cpu", 1e11, 5e10, 5e10, 5e10)


def device_peaks(device=None) -> DevicePeaks:
    """Peaks of ``device`` (a torch device or its name; default: the
    current CUDA card if there is one, else the CPU)."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return _CPU_FALLBACK
    return _PEAKS.get(torch.cuda.get_device_name(device), _CPU_FALLBACK)


def roofline(
    flops: float,
    bytes_accessed: float,
    seconds: float,
    device=None,
    dtype: str = "bf16",
) -> dict:
    """Achieved fraction of compute and bandwidth peaks; ``dtype`` picks
    the compute peak: ``"bf16"``, ``"tf32"`` or (any other) f32."""
    peaks = device_peaks(device)
    peak_flops = {"bf16": peaks.bf16_flops, "tf32": peaks.tf32_flops or peaks.f32_flops}.get(
        dtype, peaks.f32_flops
    )
    achieved_flops = flops / seconds
    achieved_bw = bytes_accessed / seconds
    return {
        "device": peaks.name,
        "seconds": seconds,
        "tflops": achieved_flops / 1e12,
        "flops_util": achieved_flops / peak_flops,
        "gbps": achieved_bw / 1e9,
        "bw_util": achieved_bw / peaks.hbm_bw,
        "bound": "compute"
        if achieved_flops / peak_flops > achieved_bw / peaks.hbm_bw
        else "memory",
    }


def throughput(elements: int, seconds: float) -> dict:
    """Snapshot-matrix elements/s — the north-star scaling metric."""
    return {
        "elements": elements,
        "seconds": seconds,
        "elements_per_s": elements / seconds,
        "gelements_per_s": elements / seconds / 1e9,
    }
