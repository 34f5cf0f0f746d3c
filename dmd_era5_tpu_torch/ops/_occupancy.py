"""Grid sizes of the row-share kernels: how many CTAs run at once on the
card, and into how many row shares a reduction over the rows is split.

Shared by the wrappers of ``ops/matmul.py`` (K1's and K2's sketch, K3),
``ops/atb.py`` (K4, K1's and K2's G and C stages) and ``ops/qr_panel.py``
(K5).
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["resident_ctas", "wave_row_shares", "SCRATCH_CAP"]

SCRATCH_CAP = 1 << 30  # f64 scratch of a row-share reduction, at most

_RESIDENT: dict[tuple, int] = {}


def resident_ctas(dev, key: tuple, query) -> int:
    """CTAs of one kernel that run at once on the card: SMs x resident
    CTAs per SM, the latter from ``query(address of an int)`` (a C
    occupancy function of the kernel's library, asked on ``dev``), cached
    under ``key``.  A cached count is read without entering the device's
    context: a small call's wrapper would otherwise spend longer here than
    its kernel on the card."""
    key = (dev.index, *key)
    if key not in _RESIDENT:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = query(ctypes.addressof(per_sm))
        if rc != 0 or per_sm.value < 1:
            raise RuntimeError(
                f"{key[1]} occupancy: CUDA error {rc}, {per_sm.value} CTAs per SM"
            )
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _RESIDENT[key] = sms * per_sm.value
    return _RESIDENT[key]


@functools.lru_cache(maxsize=4096)
def wave_row_shares(wave: int, n_blocks: int, m: int, share_bytes: int) -> int:
    """Row shares of the tensor-core row-share reduction
    (``csrc/row_share_atb_tc.cuh``), whose CTAs (n_blocks a share) run
    about one per SM: the fewest shares whose waves of ``wave`` CTAs are
    within 3% of the best filled, at most one share per 128-row tile, and
    f64 scratch (``share_bytes`` a share) within 1 GiB.  The time of a
    split into s shares goes as ceil(n_blocks s / wave) / s, and
    s = wave reaches its least, n_blocks / wave.  Memoized: a small call's
    wrapper would otherwise spend longer here than its kernel on the card."""
    cap = max(1, min(-(-m // 128), SCRATCH_CAP // share_bytes, 65535, wave))

    def waves_per_share(s: int) -> float:
        return -(-(n_blocks * s) // wave) / s

    best = min(waves_per_share(s) for s in range(1, cap + 1))
    return next(s for s in range(1, cap + 1) if waves_per_share(s) <= 1.03 * best)
