"""Device ms of K6 (``dmd_era5_tpu_torch.ops.matmul.matmul``) and of K1's
sketch stage at the shapes of ``chip_smoke.py``'s main path, for the
package of one checkout, beside one library call of the same product.

    python scripts/torch_k6_times.py [ROOT]

ROOT (default: the checkout this script is in) goes first on
``sys.path``, so two trees (say a parent unpacked by ``git archive``
beside the change) are compared on one card by running this once per
tree, in turns: parent, change, change, parent.  Each tree builds its
kernels into its own ``build/``.  Inputs are Gaussian, made on the card
from a seed.  K6 (M x K @ K x N, f32 but where named): 16e's
``hankel_sketch`` (1,038,240 x 97 @ 97 x 40), 16d's streamed block
(65,536 x 97 @ 97 x 20), 15c's U L (31,147,200 x 100 @ 100 x 24), the
week's streamed block (65,536 x 168 @ 168 x 110, f32 and bf16), 15a's
block (65,536 x 168 @ 168 x 128), a lift chunk of 15c (2,097,152 x 124 @
124 x 100) and 18b's ``hankel_sketch`` at P = 2 (7,786,800 x 168 @ 168 x
220).  K1's sketch stage alone (the wrapper's plan, ``_scgp_plan``, its
stage 1; M x T, N): the bench's shape (2^19 x 512, N 128, bf16 and f32,
centred, scalar statistics), config 2's Hankel pass (1,038,240 x 97, N
76, f32), the week's bf16 fit step (15,573,600 x 168, N 128) and f32
Hankel pass (N 256), the hourly year's streamed W (122,175 x 8,760, an
eighth of its rows, N 256) and K2's d = 3 sketch (the week in bf16, N
384).  Each time is ``chip_smoke.device_ms`` (launches queued behind a
sleep of the card, so host time drops out), the mean of 20 launches (5
past 2^28 elements of x); ``library_ms`` the same of one ``torch.mm(x,
w)`` (bf16 K6 with ``out_dtype=torch.float32``).  Needs a CUDA card and
~45 GB of its memory.  Prints one JSON line: ms by shape, the card's name.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else HERE).resolve()
sys.path[:0] = [str(ROOT), str(HERE)]  # the tree's package; chip_smoke's helpers

from chip_smoke import device_ms  # noqa: E402
from dmd_era5_tpu_torch.ops import matmul  # noqa: E402

WEEK = 721 * 1440 * 15
F32, BF16 = torch.float32, torch.bfloat16
K6 = (  # label, M, K, N, dtype
    ("16e", 1_038_240, 97, 40, F32),
    ("16d_block", 65_536, 97, 20, F32),
    ("15c_UL", 2 * WEEK, 100, 24, F32),
    ("week_block_f32", 65_536, 168, 110, F32),
    ("week_block_bf16", 65_536, 168, 110, BF16),
    ("15a_block", 65_536, 168, 128, F32),
    ("lift_chunk", 1 << 21, 124, 100, F32),
    ("18b_P2", WEEK // 2, 168, 220, F32),
)
SCALAR = dict(center=True, stats_col=False, scalar_stats=True, t_valid=None, emit_yc=True)
PLAIN = dict(center=False, stats_col=False, scalar_stats=False, t_valid=None, emit_yc=True)
SKETCH = (  # label, M, T, N, X's dtype, flags, stages of the plan (7 K1, 3 K2)
    ("sketch_bench_bf16", 1 << 19, 512, 128, BF16, SCALAR, 7),
    ("sketch_bench_f32", 1 << 19, 512, 128, F32, SCALAR, 7),
    ("sketch_config2_n76", 1_038_240, 97, 76, F32, PLAIN, 7),
    ("sketch_week_fit_bf16", WEEK, 168, 128, BF16, SCALAR, 7),
    ("sketch_week_hankel_f32", WEEK, 168, 256, F32, PLAIN, 7),
    ("sketch_year_cut_streamed", 977_400 // 8, 8760, 256, F32, PLAIN, 7),
    ("sketch_d3_k2_bf16", WEEK, 168, 384, BF16, dict(PLAIN, center=True), 3),
)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(ROOT), "device": torch.cuda.get_device_name(0)}
    for label, m, k, n, dtype in K6:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        w = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        reps = 20 if m * k < 1 << 28 else 5
        out[label] = device_ms(lambda: matmul.matmul(x, w), reps=reps)
        mm = (lambda: torch.mm(x, w, out_dtype=F32)) if dtype == BF16 else (lambda: torch.mm(x, w))
        out[f"{label}_library"] = device_ms(mm, reps=reps)
        del x, w
        torch.cuda.empty_cache()
    for label, m, t, n, dtype, flags, stages in SKETCH:
        x = torch.randn((m, t), generator=gen, device="cuda").to(dtype)
        w = torch.randn((t, n), generator=gen, device="cuda").to(dtype)
        reps = 20 if m * t < 1 << 28 else 5
        res, run = matmul._scgp_plan(x, w, dtype, **flags, stages=stages)
        run(1)
        out[label] = device_ms(lambda: run(1), reps=reps)
        del res, run
        out[f"{label}_library"] = device_ms(lambda: torch.mm(x, w), reps=reps)
        del x, w
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
