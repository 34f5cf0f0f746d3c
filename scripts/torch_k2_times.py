"""Device ms of K2 (``sketch_center_gram``) at the shapes of
``chip_smoke.py``'s main path and at the edges of its cluster route, for the
package of one checkout.

    python scripts/torch_k2_times.py [TREE] [--only LABEL,LABEL] [--library]

TREE (default: the checkout this script is in) goes first on ``sys.path``,
so two trees (say a parent unpacked by ``git archive`` into a directory
``.gitignore`` lists) are compared on one card by running this once per
tree, in turns: parent, change, change, parent.  Each tree builds its
kernels into its own ``build/``.  Inputs are Gaussian, made on the card
from a seed, the same in every tree.  Each shape is timed as a whole call
of the wrapper (``_call``) and, through the tree's plan after one whole call
has filled Yc, its sketch and G alone (``_sketch``, ``_G``): the route's
plan where the tree has ``ops.matmul._k2_plan`` (``ops/k2.py``'s table),
else K1's sketch and G stages (``ops.matmul._scgp_plan``, mask 3), as
``chip_smoke.py``'s ``k1_stage_ms`` reads them.  Times are
``chip_smoke.device_ms``: the launches queued behind a sleep of the card,
so host time drops out.  With ``--library`` the library calls of the two
stages are timed beside them (``torch.mm(x, w)`` and ``yc.T @ yc``, f32
with TF32 off; for bf16 the product in bf16, as Yc, and G with
``out_dtype=torch.float32``).  Shapes: the d = 3
pass (bf16 X 15,573,600 x 168, N 384, bf16 Yc, without and with centring;
11a), the same X at N 512 and N 264 (the route's widest and narrowest),
and the hourly year's f32 X (977,400 x 8,760) at N 256 uncentred and N 128
centred (10a's Hankel pass and fit step).  Needs a CUDA card and ~60 GB of
its memory (the year).  Prints one JSON line: ms by label, then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("tree", nargs="?", default=str(HERE))
parser.add_argument("--only", default="", help="comma-separated labels to time (default: all)")
parser.add_argument("--library", action="store_true", help="also time the stages' library calls")
ARGS = parser.parse_args()
ROOT = Path(ARGS.tree).resolve()
sys.path[:0] = [str(ROOT), str(HERE)]

from chip_smoke import device_ms  # noqa: E402
from dmd_era5_tpu_torch.ops import matmul  # noqa: E402

WEEK = 721 * 1440 * 15
YEAR = 181 * 360 * 15
F32, BF16 = torch.float32, torch.bfloat16
# label, M, T, N, X's dtype, Yc's dtype, centre
SHAPES = [
    ("K2_d3_N384", WEEK, 168, 384, BF16, BF16, False),
    ("K2_d3_N384_centred", WEEK, 168, 384, BF16, BF16, True),
    ("K2_week_N512", WEEK, 168, 512, BF16, BF16, False),
    ("K2_week_N264", WEEK, 168, 264, BF16, BF16, True),
    ("K2_year_N256", YEAR, 8760, 256, F32, F32, False),
    ("K2_year_N128", YEAR, 8760, 128, F32, F32, True),
]


def plan(x, w, out_dtype, center):
    """(outputs, run(mask)) of the tree's route for this call."""
    if hasattr(matmul, "_k2_plan"):
        out, run, _ = matmul._k2_plan(x, w, out_dtype, center, None)
        return out, run
    return matmul._scgp_plan(x, w, out_dtype, center, False, False, None, True, stages=3)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    only = set(ARGS.only.split(",")) - {""}
    out = {"root": str(ROOT)}
    for label, m, t, n, xdt, odt, center in SHAPES:
        if only and label not in only:
            continue
        gen = torch.Generator(device="cuda").manual_seed(m + n)
        x = torch.randn((m, t), generator=gen, device="cuda").to(xdt)
        w = torch.randn((t, n), generator=gen, device="cuda").to(xdt)
        reps = 3 if m * t > 1 << 32 else 5
        call = lambda: matmul.sketch_center_gram(x, w, out_dtype=odt, center=center)  # noqa: E731
        out[label + "_call"] = device_ms(call, reps)
        res, run = plan(x, w, odt, center)
        run(3)
        out[label + "_sketch"] = device_ms(lambda: run(1), reps)
        out[label + "_G"] = device_ms(lambda: run(2), reps)
        if ARGS.library:
            yc = res["yc"]
            if xdt == BF16:
                out[label + "_sketch_library"] = device_ms(lambda: torch.mm(x, w), reps)
                out[label + "_G_library"] = device_ms(
                    lambda: torch.mm(yc.T, yc, out_dtype=torch.float32), reps)
            else:
                out[label + "_sketch_library"] = device_ms(lambda: torch.mm(x, w), reps)
                out[label + "_G_library"] = device_ms(lambda: yc.T @ yc, reps)
            del yc
        del x, w, res, run
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
