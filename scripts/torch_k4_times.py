"""Device ms of K4 (``gram(a, "highest")``) and of K1's G and C stages and
K2's G stage at the shapes of ``chip_smoke.py``'s main path, for the
package of one checkout.

    python scripts/torch_k4_times.py [TREE] [--only LABEL,LABEL]

TREE (default: the checkout this script is in) goes first on
``sys.path``, so two trees (say a parent unpacked by ``git archive`` into
a directory ``.gitignore`` lists) are compared on one card by running this
once per tree, in turns: parent, change, change, parent.  Each tree builds
its kernels into its own ``build/``.  Inputs are Gaussian, made on the
card from a seed.  K4 runs through ``ops.qr_panel.gram``; a stage of K1
or K2 through the wrapper's plan (``ops.matmul._scgp_plan``, its
``run(mask)`` after one whole call has filled Yc), as ``chip_smoke.py``'s
``k1_stage_ms`` reads them.  Times are ``chip_smoke.device_ms``: the
launches queued behind a sleep of the card, so host time drops out; the
small K4 calls (19c, 19d) are also timed back to back from the host
(CUDA events, ``event_ms``), as a caller sees them.  The library call of
the same function (``a.T @ a``, ``yc.T @ yc``, ``yc.T @ x``; bf16 with
``out_dtype=torch.float32``) is timed beside each, in the same process.
With ``--c-blocks`` each C stage is also timed on K3's kernel
(``ops.matmul._project_cuda``) in the tree's other blocks of C: the one
``project_block`` gives (``k3_table``), Y's columns on the MMA's m side
and X's on it (``k3_y_on_m``, ``k3_x_on_m``: the n side cut into the
fewest pieces of at most 88 columns), and, for f32, the row-share
mainloop's 128 x 128 blocks (``k3_row_share``); the tree's own route is
timed again after them (``_C_again``).
Needs a CUDA card and ~60 GB of its memory (the hourly year's X).
Prints one JSON line: ms by label, then the card's name and power limit.
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
parser.add_argument("--c-blocks", action="store_true",
                    help="also time each C stage on K3's kernel in its other blocks")
ARGS = parser.parse_args()
ROOT = Path(ARGS.tree).resolve()
sys.path[:0] = [str(ROOT), str(HERE)]

from chip_smoke import device_ms, event_ms  # noqa: E402
from dmd_era5_tpu_torch.ops import matmul, qr_panel  # noqa: E402

WEEK = 721 * 1440 * 15
YEAR = 181 * 360 * 15
F32, BF16 = torch.float32, torch.bfloat16
# K4: label, M, K, dtype
GRAMS = [("K4_15a_Y_block", 65_536, 128, F32), ("K4_14d_block", 65_536, 168, F32),
         ("K4_19c_stack", 34, 166, F32), ("K4_19d_block6", 6, 95, F32), ("K4_19d_block5", 5, 95, F32),
         ("K4_week_Y", WEEK, 110, F32), ("K4_week_X", WEEK, 168, F32), ("K4_14c_window", 2 * WEEK, 82, F32)]
# K1's (stages 7) and K2's (stages 3) G and C stages: label, M, T, N, dtype, flags, stages
STAGES = [
    ("K1_hankel_week_N256", WEEK, 168, 256, F32, dict(center=False), 7),
    ("K1_fit_week_f32", WEEK, 168, 128, F32, dict(center=True, scalar_stats=True), 7),
    ("K1_fit_week_bf16", WEEK, 168, 128, BF16, dict(center=True, scalar_stats=True), 7),
    ("K1_bench_f32", 1 << 19, 512, 128, F32, dict(center=True, scalar_stats=True), 7),
    ("K1_bench_bf16", 1 << 19, 512, 128, BF16, dict(center=True, scalar_stats=True), 7),
    ("K1_config2_N76", 1_038_240, 97, 76, F32, dict(center=False), 7),
    ("K1_17b_P2_N128", WEEK // 2, 168, 128, F32, dict(center=True, scalar_stats=True), 7),
    ("K1_18b_P2_N256", WEEK // 2, 168, 256, F32, dict(center=False), 7),
    ("K1_year_N256", YEAR, 8760, 256, F32, dict(center=False), 7),
    ("K2_d3_N384_bf16", WEEK, 168, 384, BF16, dict(center=True), 3),
]


def library_ms(fn, reps):
    return device_ms(fn, reps)


def k3_blocks(m: int, n: int, t: int, dtype: torch.dtype) -> dict:
    """K3's blocks of C = Y^T X (n x t) to time beside a C stage's own route."""

    def oriented(transposed: bool):
        wide, narrow = (t, n) if transposed else (n, t)
        pieces = -(-narrow // 88)
        bn = 8 * -(-(-(-narrow // pieces)) // 8)
        return matmul.ProjectBlock(transposed, 128, bn, -(-wide // 128), -(-narrow // bn),
                                   "registers" if bn <= 64 else "shared")

    out = {"k3_table": matmul.project_block(m, n, t, dtype, dtype), "k3_y_on_m": oriented(False),
           "k3_x_on_m": oriented(True)}
    if dtype == F32:
        out["k3_row_share"] = matmul.ProjectBlock(False, 128, 128, -(-n // 128), -(-t // 128),
                                                  "shared", "row_share")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    only = set(ARGS.only.split(",")) - {""}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(ROOT)}
    for label, m, k, dtype in GRAMS:
        if only and label not in only:
            continue
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        reps = 20 if m * k < 1 << 26 else 5
        qr_panel.gram(a)
        out[label] = device_ms(lambda: qr_panel.gram(a), reps)
        out[label + "_library"] = library_ms(lambda: a.T @ a, reps)
        if m < 1000:  # host-issued, back to back: what a caller of a small call sees
            out[label + "_host"] = event_ms(lambda: qr_panel.gram(a), 200)
            out[label + "_library_host"] = event_ms(lambda: a.T @ a, 200)
        del a
        torch.cuda.empty_cache()
    for label, m, t, n, dtype, flags, stages in STAGES:
        if only and label not in only:
            continue
        x = torch.randn((m, t), generator=gen, device="cuda").to(dtype)
        w = torch.randn((t, n), generator=gen, device="cuda").to(dtype)
        args = {key: flags.get(key, default) for key, default in (
            ("center", True), ("stats_col", False), ("scalar_stats", False), ("t_valid", None),
            ("emit_yc", True))}
        res, run = matmul._scgp_plan(x, w, dtype, **args, stages=stages)
        run(stages)
        reps = 3 if m * t > 1 << 32 else 5
        yc = res["yc"]
        out[label + "_G"] = device_ms(lambda: run(2), reps)
        mm = (lambda p, q: torch.mm(p, q, out_dtype=torch.float32)) if dtype == BF16 else torch.mm
        out[label + "_G_library"] = library_ms(lambda: mm(yc.T, yc), reps)
        if stages & 4:
            out[label + "_C"] = device_ms(lambda: run(4), reps)
            out[label + "_C_library"] = library_ms(lambda: mm(yc.T, x), reps)
            if ARGS.c_blocks:
                for name, block in k3_blocks(m, n, t, dtype).items():
                    out[f"{label}_C_{name}"] = device_ms(
                        lambda block=block: matmul._project_cuda(x, yc, block), reps)
                    out[f"{label}_C_{name}_block"] = block._asdict()
                out[label + "_C_again"] = device_ms(lambda: run(4), reps)
        del x, w, res, run, yc
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
