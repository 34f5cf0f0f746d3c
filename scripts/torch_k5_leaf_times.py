"""K5 at phase 20's CholQR2 leaves as a caller waits for it: the time of
``gram(a, "bf16_split")`` issued back to back by the host, for the
kernels of two trees loaded in one process and timed in turns.

    python scripts/torch_k5_leaf_times.py --tree PATH

At these shapes (512-5,184 rows x 18-96 columns) the card works ~0.01
ms a call and the host's own path takes the rest, so two processes on a
shared host read apart by more than the kernels differ; one process, in
turns (PATH, this tree, this tree, PATH, PATH, this tree), does not.
``PATH`` is another checkout (say the parent commit, unpacked by ``git
archive``); both are built by ``scripts/torch_k5_phases.py``'s ``build``
and driven through this tree's ``qr_panel.gram``, so both must share
``gram.cu``'s C entry (``gram_launch(a, part, g, m, k, n_share, stream)``;
older trees' took ``a_bf16`` and ``split`` too).  Each reading: CUDA-event
ms over 50 calls and the host's microseconds to issue one (no sync inside).
Prints one JSON line a shape.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch_k5_phases as phases  # noqa: E402
from chip_smoke import event_ms  # noqa: E402
from dmd_era5_tpu_torch.ops import qr_panel  # noqa: E402

LEAVES = ((4096, 96), (4096, 22), (1536, 18), (512, 64), (5184, 24))
TURNS = ("other", "this", "this", "other", "other", "this")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", required=True, help="the other checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    other = Path(args.tree).resolve()
    out = ROOT / "build" / "k5_leaf_times"
    libs = {"other": phases.build(other, out / "other", "kernel"),
            "this": phases.build(ROOT, out / "this", "kernel")}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k in LEAVES:
        a = torch.randn((m, k), generator=gen, device=dev)
        row = {"shape": f"{m}x{k}", "other": str(other)}
        for name in TURNS:
            phases.use(libs[name])
            ms = event_ms(lambda: qr_panel.gram(a, "bf16_split"), reps=50)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                qr_panel.gram(a, "bf16_split")
            issue_us = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
            row.setdefault(f"{name}_ms_issue_us", []).append([ms, issue_us])
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
