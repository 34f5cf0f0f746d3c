"""How far a bf16 K1 (``sketch_center_gram_project``) rounds its Yc like
the plain version, for the package of one or more trees.

    python scripts/torch_k1_flips.py TREE [TREE ...]

TREE is a directory that holds a ``dmd_era5_tpu_torch`` package (``.``
for this checkout; an older tree unpacked with ``git archive <rev> | tar
-x -C build/ab/P``, each of which builds its own kernels under its own
``build/``).  For each tree, on the card's test data (M 1,000 rows of
randn + 2, the seed of ``tests/test_torch_cuda.py``) at T 168 and N 256
and 100, and at T 700 and N 256: how many entries of the bf16 Yc differ
from the plain version's, how many of an f32 Yc do, and G's and C's
relative Frobenius difference from the plain version's.  A kernel whose
f32 Yc equals the plain version's in every entry sums Y in cuBLAS's
order; any other order rounds a few bf16 entries the other way.  One
JSON line a shape.  Then, over the bf16 cases of
``tests/test_torch_cuda.py``'s K1 tests (T 168 at N 100 and 256, T 700 at
its nine widths, every combination of the flags that shape Yc: centring,
the stats column, a zero tail of 5 columns), the share of Yc's entries
that differ from the plain version's (the card tests' limit) and, of
those, the share the kernel rounded up: one JSON line a (T, N) with its
largest share and that case's flags, and the largest of all.  Needs one
CUDA card.
"""

from __future__ import annotations

import importlib
import itertools
import json
import sys

import torch


def main() -> None:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        raise SystemExit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for tree in sys.argv[1:]:
        for name in [m for m in sys.modules if m.startswith("dmd_era5_tpu_torch")]:
            del sys.modules[name]
        sys.path.insert(0, tree)
        matmul = importlib.import_module("dmd_era5_tpu_torch.ops.matmul")
        sys.path.pop(0)
        for t, n in ((168, 256), (168, 100), (700, 256)):
            gen = torch.Generator(device=dev).manual_seed(7)
            x = (torch.randn((1000, t), generator=gen, device=dev) + 2.0).bfloat16()
            w = torch.randn((t, n), generator=gen, device=dev).bfloat16()
            got = matmul.sketch_center_gram_project(x, w, out_dtype=torch.bfloat16)
            ref = matmul._sketch_center_gram_project_plain(x, w, out_dtype=torch.bfloat16)
            y32 = matmul.sketch_center_gram_project(x, w, out_dtype=torch.float32)[0]
            y32_plain = matmul._sketch_center_gram_project_plain(x, w, out_dtype=torch.float32)[0]

            def rel(a, b):
                return float((a.double() - b.double()).norm() / b.double().norm())

            print(json.dumps({
                "tree": tree, "m": 1000, "t": t, "n": n,
                "bf16_yc_entries_differing": int((got[0] != ref[0]).sum()),
                "f32_yc_entries_differing": int((y32 != y32_plain).sum()), "entries": y32.numel(),
                "G_vs_plain": rel(got[3], ref[3]), "C_vs_plain": rel(got[4], ref[4]),
            }), flush=True)
        worst = (0.0, None)
        for t, widths in ((168, (100, 256)), (700, (100, 112, 113, 128, 129, 168, 224, 225, 256))):
            for n in widths:
                shares = {}
                for center, stats_col, tail in itertools.product((True, False), repeat=3):
                    gen = torch.Generator(device=dev).manual_seed(7)
                    x = torch.randn((1000, t), generator=gen, device=dev) + 2.0
                    t_valid = t - 5 if tail else None
                    if tail:
                        x[:, t_valid:] = 0.0
                    x = x.bfloat16()
                    w = torch.randn((t, n), generator=gen, device=dev).bfloat16()
                    flags = dict(out_dtype=torch.bfloat16, center=center, stats_col=stats_col,
                                 t_valid=t_valid)
                    got = matmul.sketch_center_gram_project(x, w, **flags)[0]
                    ref = matmul._sketch_center_gram_project_plain(x, w, **flags)[0]
                    differ = got != ref
                    n_differ = int(differ.sum())
                    up = int((got.float() > ref.float())[differ].sum())
                    shares[f"c{center:d}-sc{stats_col:d}-tv{tail:d}"] = (
                        n_differ / got.numel(), up / n_differ if n_differ else None)
                case = max(shares, key=lambda key: shares[key][0])
                worst = max(worst, (shares[case][0], f"t{t}-n{n}-{case}"), key=lambda c: c[0])
                ups = [v[1] for v in shares.values() if v[1] is not None]
                print(json.dumps({"tree": tree, "m": 1000, "t": t, "n": n,
                                  "largest_share": shares[case][0], "of_case": case,
                                  "rounded_up_share": shares[case][1],
                                  "rounded_up_range": [min(ups), max(ups)] if ups else None}),
                      flush=True)
        print(json.dumps({"tree": tree, "largest_share_of_all": worst[0], "case": worst[1]}),
              flush=True)


if __name__ == "__main__":
    main()
