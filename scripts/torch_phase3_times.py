"""Where the wall time of ``chip_smoke.py``'s phase 3 goes: the randomized
Hankel SVD (d = 2, k = 100, f32, K1 five times) on the ERA5-week X, taken
several times in one process.

    python scripts/torch_phase3_times.py [--samples 5]

The process first does what the smoke does before phase 3 (the card's
set-up, the kernels' build, phase 2's K1 comparisons), then generates and
centres the week's X as phase 3 does, and times
``hankel_randomized_svd_fused`` ``--samples`` times between device
synchronizations, as the smoke does.  Inside a sample nothing
synchronizes more than the call itself does: each call of the functions
it makes (K1, the Cholesky whitener, the small QR, the small SVD, the
lift of U) is recorded by the host's clock around it and by CUDA events
around its work, read after the sample.  Each sample also counts the
caching allocator's device allocations, frees and retries.  Prints one
JSON line a sample, then the card's name and power limit.  Needs one
CUDA card, nvcc and ~40 GB of the card's memory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dmd_era5_tpu_torch.ops import hankel  # noqa: E402
from dmd_era5_tpu_torch.snapmat import standardize_data  # noqa: E402

CALLS = ("sketch_center_gram_project", "gram_whiten", "orth_small", "_lift_blocks")


@contextlib.contextmanager
def recorded(module, *names: str):
    """Each call of ``module.<name>`` inside, as (name, host seconds, start
    and end events), into the yielded list; no synchronization added."""
    saved = {name: getattr(module, name) for name in names}
    calls = []

    def wrap(name):
        def call(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out = saved[name](*args, **kwargs)
            host = time.perf_counter() - t0
            end.record()
            calls.append((name, host, start, end))
            return out
        return call

    for name in names:
        setattr(module, name, wrap(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def allocator_counts() -> dict:
    stats = torch.cuda.memory_stats()
    return {key: stats.get(key, 0) for key in ("num_device_alloc", "num_device_free",
                                                "num_alloc_retries")}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--samples", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    chip_smoke.phase_kernel_vs_plain(args.seed)
    x = chip_smoke.make_era5_week(args.seed)[0]
    x = standardize_data(x, scale=False)[0]
    for sample in range(args.samples):
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
        before = allocator_counts()
        with recorded(hankel, *CALLS) as calls, recorded(torch.linalg, "svd") as svd_calls:
            _, secs = chip_smoke.synced(hankel.hankel_randomized_svd_fused, x, 2, 100,
                                        generator=gen, gemm_dtype=torch.float32)
        after = allocator_counts()
        host, device = {}, {}
        for name, h, start, end in calls + svd_calls:
            host.setdefault(name, []).append(h)
            device.setdefault(name, []).append(start.elapsed_time(end) / 1e3)
        print(json.dumps({"sample": sample, "hankel_svd_s": secs, "host_s": host,
                          "device_s": device, "device_sum_s": sum(map(sum, device.values())),
                          "allocator": {k: after[k] - before[k] for k in after}}), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
