"""CUDA-event ms of K3 (``dmd_era5_tpu_torch.ops.matmul.project``) at the
shapes of ``chip_smoke.py``'s main path, for the package of one checkout.

    python scripts/torch_k3_times.py [ROOT]

ROOT (default: the checkout this script is in) goes first on
``sys.path``, so two trees (say a parent unpacked by ``git archive``
beside the change) are compared on one card by running this once per
tree, in turns: parent, change, change, parent.  Each tree builds its
kernels into its own ``build/``.  Inputs are Gaussian, made on the card
from a seed: the year (977,400 x 8,760 f32 X; Y of 256 and of 128
columns, f32) and the d = 3 pass (15,573,600 x 168 bf16 X, Y of 384
columns, bf16).  Needs a CUDA card and about 36 GB of its memory.
Prints one JSON line: ms by shape, the mean of 5 launches after one.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

from dmd_era5_tpu_torch.ops import matmul  # noqa: E402

SHAPES = (  # label, M, T, N, dtype
    ("year_n256_f32", 977_400, 8_760, 256, torch.float32),
    ("year_n128_f32", 977_400, 8_760, 128, torch.float32),
    ("d3_n384_bf16", 15_573_600, 168, 384, torch.bfloat16),
)


def event_ms(fn, reps: int = 5) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(ROOT), "device": torch.cuda.get_device_name(0)}
    x = None
    for label, m, t, n, dtype in SHAPES:
        if x is None or x.shape != (m, t) or x.dtype != dtype:
            x = None
            x = torch.randn((m, t), generator=gen, device="cuda").to(dtype)
        y = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
        out[label] = event_ms(lambda: matmul.project(x, y))
        del y
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
