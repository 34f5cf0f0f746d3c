"""CUDA-event ms of K3 (``dmd_era5_tpu_torch.ops.matmul.project``) at the
shapes of ``chip_smoke.py``'s main path, for the package of one checkout.

    python scripts/torch_k3_times.py [ROOT]

ROOT (default: the checkout this script is in) goes first on
``sys.path``, so two trees (say a parent unpacked by ``git archive``
beside the change) are compared on one card by running this once per
tree, in turns: parent, change, change, parent.  Each tree builds its
kernels into its own ``build/``.  Inputs are Gaussian, made on the card
from a seed, at the K3 shapes of ``chip_smoke.py`` (X M x T, Y M x N):
the year (977,400 x 8,760 f32 X; Y of 256 and of 128 columns, f32), the
d = 3 pass (15,573,600 x 168 bf16 X, Y of 384 columns, bf16), 15a's block
(65,536 x 168, N 256), 15c's U^T C (31,147,200 x 24, N 100), 16e's
``hankel_project`` (1,038,240 x 97, N 40), 18b's at P = 2 and 3 (7,786,800
and 5,191,200 x 168, N 220) and 18c's (524,288 x 84, N 220), all f32 but
the d = 3 pass.  Needs a CUDA card and about 36 GB of its memory.  Prints
one JSON line: ms by shape, the mean of 10 launches after one (20 where a
launch takes under 2 ms).
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
    ("15a_block_f32", 65_536, 168, 256, torch.float32),
    ("15c_UtC_f32", 31_147_200, 24, 100, torch.float32),
    ("16e_hankel_project_f32", 1_038_240, 97, 40, torch.float32),
    ("18b_P2_f32", 7_786_800, 168, 220, torch.float32),
    ("18b_P3_f32", 5_191_200, 168, 220, torch.float32),
    ("18c_rank0_f32", 524_288, 84, 220, torch.float32),
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
            torch.cuda.empty_cache()
            x = torch.randn((m, t), generator=gen, device="cuda").to(dtype)
        y = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
        matmul.project(x, y)
        torch.cuda.synchronize()
        first = event_ms(lambda: matmul.project(x, y), reps=1)
        out[label] = event_ms(lambda: matmul.project(x, y), reps=20 if first < 2 else 10)
        del y
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
