#!/usr/bin/env python3
"""Time CholQR's whitening solve Q R = A on one CUDA card, by form.

    python3 scripts/torch_trsm_rows.py

For tall panels A (m x n) with R = chol(A^T A)^T, times (host clock
after a synchronize, one call after a warm-up) the solve
R^T Q^T = A^T over all rows at once, over row blocks of 2^16 and 2^20
rows (``ops.qr_panel.cholqr`` takes ``SOLVE_ROWS`` = 2^16), the
right-sided solve, and the product with R's inverse; and says whether
each blocked Q equals the one-call Q bit for bit.  Shapes: the unfused
Hankel SVD's sketch at config.ini's window on the 0.25-degree grid
(2,076,480 x 20, 40), wider panels and the ERA5 week's 15,573,600 x 100.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import time

import torch


def timed(fn, reps: int = 1):
    """(result, mean seconds of reps calls after one warm-up)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps


def blocked(r: torch.Tensor, a: torch.Tensor, rows: int) -> torch.Tensor:
    q = torch.empty_like(a)
    for r0 in range(0, a.shape[0], rows):
        q[r0:r0 + rows] = torch.linalg.solve_triangular(r.T, a[r0:r0 + rows].T, upper=False).T
    return q


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n in ((2_076_480, 20), (2_076_480, 40), (2_076_480, 64), (2_076_480, 100),
                 (15_573_600, 100), (262_144, 20)):
        a = torch.randn((m, n), generator=gen, device="cuda")
        r = torch.linalg.cholesky(a.T @ a).T
        one, t_one = timed(lambda: torch.linalg.solve_triangular(r.T, a.T, upper=False).T
                           .contiguous())
        row = {"m": m, "n": n, "one_call_s": t_one}
        for rows in (1 << 16, 1 << 20):
            q, row[f"rows_{rows}_s"] = timed(lambda: blocked(r, a, rows))
            row[f"rows_{rows}_equal"] = bool(torch.equal(q, one))
        _, row["right_sided_s"] = timed(lambda: torch.linalg.solve_triangular(
            r, a, upper=True, left=False))
        r_inv = torch.linalg.solve_triangular(r, torch.eye(n, device="cuda"), upper=True)
        _, row["times_inverse_s"] = timed(lambda: a @ r_inv)
        print(row, flush=True)
        del a, r, one


if __name__ == "__main__":
    main()
