#!/usr/bin/env python3
"""Drive the port's main path once on one NVIDIA GPU, at ERA5-week size.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout of this repository, on a machine with
one CUDA card (an H100: the kernels are built for sm_90a).  Phases, each
of which raises on failure so the script exits non-zero:

0. device: name and power limit from nvidia-smi; full-f32 matmul flags;
1. build: one nvcc per kernel source of ``dmd_era5_tpu_torch/ops/csrc``,
   all started together, into ``build/dmd_era5_tpu_torch/``;
2. K1 (the fused sketch/Gram/projection kernel) against its plain
   PyTorch version on the card, at the fit step's bench shape and at a
   2^20-row Hankel shape, with times;
3. the slice at one week of hourly 0.25-degree ERA5 (15 variable-level
   blocks of 721 x 1440 rows, 168 hours), generated on the device from
   the seed: centre rows, randomized Hankel SVD (d = 2, k = 100),
   optDMD (rank 6), a 24-step forecast;
4. the fused fit step (k = 100, sketch 128) on the same matrix, f32 and
   bf16;
5. K1 against its plain version again, on that matrix with the sketch
   widths and flags the main path gave it;
6. the Gram kernels K4 (full f32) and K5 (bf16 split) against their
   plain versions and the f64 sums, on that matrix and on a 110-column
   sketch of it;
7. the ``svd_type = standard`` path on that matrix: exact Hankel SVD
   (d = 2, k = 100) -> optDMD -> forecast, with phase 3's randomized
   singular values held below the exact ones;
8. ``truncated_svd`` at d = 1 on that matrix by its four routes (Gram
   route with K5, Gram route with K4, TSQR, randomized), held to one
   another;
9. the out-of-core SVD at the same size: (a) the tiled matmul K6 and the
   Householder panel K7 against their plain versions at the streamed
   path's shapes (K7 also at its envelope's edges), K6 also against the
   f64 product with a one-TF32-pass control, and both kernels' device
   times beside their wrappers' and the library's; (b) the centred X
   written from the card to a packed
   ``.npy`` artifact (10.47 GB) in a temporary directory (``TMPDIR``),
   deleted at the end; (c) ``streamed_randomized_svd`` on it (65,536-row
   blocks, n_iter auto = 4: six passes, K6 on every block of five, K7
   four times), then (e) optDMD and the forecast on its result at d = 1;
   (d) ``streamed_exact_gram_svd`` (2^18-row blocks, no kernel); both
   held to phase 8 (b) and to an out-of-core bound on device memory;
11. (run next, on the week still on the card) (a) K2 and K3 against
   their plain versions at the shapes and types of the pass below, with
   times; then the randomized Hankel SVD at d = 3, k = 100 in bf16: a
   384-wide sketch, past the fused kernel K1, so each of its five passes
   takes the two-pass route (K2 ``sketch_center_gram`` then K3
   ``project``), then optDMD and the forecast;
10. one year of hourly 1-degree ERA5 (181 x 360 points, 15 variable-level
   blocks, 8,760 hours: 977,400 rows), generated on the card from the
   seed after the week is freed, centred in place, with the exact
   singular values of X and of its d = 2 Hankel embedding from an f64
   Gram and f64 ``eigvalsh``: (a) K2 and K3 against their plain versions
   at the path's shapes, with times, K5 on X (K = 8,760) against the
   f64 Gram of the references (no plain version: it does not fit), and
   K7 on Z = X^T (X Omega) (8,760 x 110, spectrum s^2), the panel that
   the streamed randomized route's first leaf gets from this year; (b)
   the SVD stage's dispatcher ``svd_on_era5`` on ``config.ini``'s
   ``[era5-svd]`` defaults at that size (hankel, randomized, f32: eight
   two-pass passes); (c) optDMD and
   the forecast on it; (d) ``svd_type = standard`` through the same
   dispatcher (the exact Hankel SVD: K5 once, one two-pass pass); (e)
   ``fit_step_fused`` and ``fit_step_lean`` (k = 100, sketch 128)
   against each other, against the exact loss and a control; (b), (d)
   and (e)'s singular values are held below the exact ones; (f) K1 and
   the two-pass route timed on the same X and sketch.

Phases 3-4, 7, each call of 8, 9c-e, 9d, 11 and 10b-e are the main path:
every kernel's launch count is set to 0 just before each and read just
after, and checked exactly.  The comparisons (2, 5, 6, 9a, 11a, 10a,
10f) are not counted.  The last line is the JSON result; the line before
it the card's name and power limit; before that one JSON line with every
kernel, and before that one line a K1 comparison with the device ms of
each of K1's three stages (sketch, G, C).  Without CUDA the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CSRC = "dmd_era5_tpu_torch/ops/csrc"
# name, source, the TPU kernel it replaces, by key of the launch counts
KERNELS = {
    "K1": ("sketch_center_gram_project", f"{CSRC}/sketch_center_gram_project.cu",
           "dmd_era5_tpu/ops/matmul.py:183"),
    # one kernel for the TPU's whole-T (K2a) and T-tiled (K2b) variants
    "K2": ("sketch_center_gram", f"{CSRC}/sketch_center_gram.cu",
           "dmd_era5_tpu/ops/matmul.py:142, dmd_era5_tpu/ops/matmul.py:442"),
    "K3": ("project", f"{CSRC}/project.cu", "dmd_era5_tpu/ops/matmul.py:593"),
    "K4": ("gram_highest", f"{CSRC}/gram.cu", "dmd_era5_tpu/ops/qr_panel.py:40"),
    "K5": ("gram_bf16_split", f"{CSRC}/gram.cu", "dmd_era5_tpu/ops/qr_panel.py:62"),
    "K6": ("matmul", f"{CSRC}/matmul.cu", "dmd_era5_tpu/ops/matmul.py:79"),
    "K7": ("householder_panel", f"{CSRC}/householder.cu", "dmd_era5_tpu/ops/qr_panel.py:212"),
}
# H100 SXM published peaks (NVIDIA data sheet, dense): f32 on CUDA cores,
# bf16 and TF32 on tensor cores, HBM3
PEAK_F32, PEAK_BF16, HBM_BYTES_S = 67e12, 989e12, 3.35e12
PEAK_TF32 = 495e12

# one week of hourly 0.25-degree ERA5, 3 variables x 5 pressure levels
N_LAT, N_LON, N_BLOCKS, T_HOURS = 721, 1440, 15, 168
LEVELS = (1000.0, 850.0, 700.0, 500.0, 250.0)
# planted damped oscillating pairs: damping (1/h), period (h), amplitude (K)
PAIRS = ((-0.002, 24.0, 12.0), (-0.004, 12.0, 8.0), (-0.001, 84.0, 6.0))
NOISE_FRACTION = 0.01  # noise std relative to the planted signal's rms
CHUNK = 1 << 20
# truncated_svd's TSQR route on the row-centred week (phase 8 (c)), a known
# fault: brackets around its readings on an H100 (max|U^T U - I| 1.41e-3,
# leading 6 s 7.0e-5 off the Gram route's)
TSQR_CENTRED_FAULT = {"orth": (5e-4, 2e-3), "lead6": 2e-4}
# the streamed SVD's blocks (the JAX package's defaults) and sketch width
RAND_BLOCK, EXACT_BLOCK, R_SKETCH = 1 << 16, 1 << 18, 110
GIB = 1 << 30
# one year of hourly 1-degree ERA5 (2019), the same 15 variable-level
# blocks; pairs damped slowly enough to keep >= 10% of their amplitude
# at hour 8,760
YEAR_LAT, YEAR_LON, YEAR_DEG, YEAR_HOURS = 181, 360, 1.0, 8760
YEAR_PAIRS = ((-1e-4, 24.0, 12.0), (-2e-4, 12.0, 8.0), (-5e-5, 730.0, 6.0))
# config.ini's [era5-svd] with only these overrides (phase 10 b, d)
YEAR_CONFIG = dict(start_datetime="2019-01-01T00", end_datetime="2019-12-31T23",
                   variables="temperature,u_component_of_wind,v_component_of_wind",
                   levels="1000,850,700,500,250", n_components=100)
# the year's fit step (phase 10 e) on an H100: its loss over the exact
# rank-100 loss, at most (reads 1.0182; the control, the same fit with
# components 7-100 dropped, 1.0234); the share of the exact energy of
# components 7-100 that its s must hold (reads 0.852; 0 without them)
FIT_LOSS_LIMIT = 1.021
FIT_TAIL_SHARE_MIN = 0.8
# K3's C against the f64 sums at the main path's shapes (the year's N 256
# and N 128, the d = 3 pass), of max|C|: 3xTF32 reads 0.9-1.0e-7 there on
# an H100, the f32 library product 5.3e-7; one TF32 pass must read above it
K3_F64_LIMIT = 2e-7
# K6's out against the f64 product at the streamed block and its ragged tail
# (f32 operands), of max|out|: at most this many times the plain f32
# product's error in the same run (3xTF32 with the MMA sums restarted every
# chunk reads 1.9e-7 and 2.2e-7 there on an H100, the plain version 4.9e-7
# and 5.2e-7, one TF32 pass 8.9e-5 and 9.2e-5; the MMAs chained over a tile,
# scripts/torch_k6_phases.py's `chained` variant, 1.6e-6 and 2.0e-6)
K6_F64_FACTOR = 2.0
# K1's stage device times (sketch, G, C) by shape, printed before the kernels line
K1_STAGES: list[dict] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def synced(fn, *args, **kwargs):
    """(result, seconds) of fn, between two device synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn in ms, by CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn in ms, by CUDA events, after one warm-up:
    the launches are queued behind a sleep of the card, so that it runs
    them back to back however long the host takes to issue each one (the
    sleep grows until the host is done before it ends)."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()  # the card still sleeps: every launch is queued
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        check(cycles < 1 << 32, "device_ms: the host never got ahead of the card")
        cycles *= 4


def phase_device() -> str:
    check(torch.cuda.is_available(), "CUDA is not available: this script needs a GPU")
    check((ROOT / "dmd_era5_tpu_torch").is_dir(), f"no dmd_era5_tpu_torch package beside {__file__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # a float32 product on the card is full f32 (the JAX package's HIGHEST)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"[0] device {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | TF32 off, matmul precision highest")
    return smi


def phase_build() -> None:
    from dmd_era5_tpu_torch.ops import _build, matmul, qr_panel

    names = sorted({Path(src).stem for _, src, _ in KERNELS.values()})
    loaders = (matmul._kernel_library, matmul._scg_library, matmul._project_library,
               matmul._matmul_library, qr_panel._kernel_library, qr_panel._householder_library)
    t0 = time.perf_counter()
    # each loader runs its own nvcc at first use; threads start them together
    with ThreadPoolExecutor(max_workers=len(loaders)) as pool:
        for fut in [pool.submit(f) for f in loaders]:
            fut.result()
    log(f"[1] built {', '.join(names)} in {time.perf_counter() - t0:.2f} s "
        "(nvcc, sm_90a, one process per source)")
    for name in names:
        for path in sorted(_build.BUILD_DIR.glob(f"{name}_*.log")):
            for line in path.read_text().splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    log(f"    ptxas {name}: {line.strip()}")


def launch_counts() -> dict:
    """The kernels' launch counts, by key of KERNELS."""
    from dmd_era5_tpu_torch.ops import matmul, qr_panel

    return {"K1": matmul.sketch_center_gram_project.launches,
            "K2": matmul.sketch_center_gram.launches,
            "K3": matmul.project.launches,
            "K4": qr_panel.gram.launches["highest"],
            "K5": qr_panel.gram.launches["bf16_split"],
            "K6": matmul.matmul.launches,
            "K7": qr_panel.householder_panel.launches}


def counts(**nonzero: int) -> dict:
    """Expected launch counts: the given ones, 0 for every other kernel."""
    return {key: nonzero.get(key, 0) for key in KERNELS}


def reset_counts() -> None:
    from dmd_era5_tpu_torch.ops import matmul, qr_panel

    matmul.sketch_center_gram_project.launches = 0
    matmul.sketch_center_gram.launches = 0
    matmul.project.launches = 0
    matmul.matmul.launches = 0
    qr_panel.gram.launches.update({p: 0 for p in qr_panel.gram.launches})
    qr_panel.householder_panel.launches = 0


@contextlib.contextmanager
def one_tf32_pass():
    """f32 library products in one TF32 pass inside, the flag restored: the
    control that a 3xTF32 kernel's accuracy limit must tell apart."""
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def bound(flops: float, peak: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate for their type and the bytes (each
    input read once, each output written once) over the HBM rate."""
    t_ops, t_mem = flops / peak, nbytes / HBM_BYTES_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def _chunk_rows(*arrays: torch.Tensor) -> int:
    """Rows per chunk: 2^19, fewer where an f64 copy of a chunk of the
    widest array would pass 1 GiB (the year's X is 8,760 wide)."""
    width = max([1, *(a.shape[1] for a in arrays if a.ndim == 2)])
    return max(1, min(1 << 19, GIB // (8 * width)))


def _chunks(a: torch.Tensor, rows: int | None = None):
    """Row chunks of a (a 0-d tensor as one chunk of one)."""
    a = a.reshape(1) if a.ndim == 0 else a
    rows = rows or _chunk_rows(a)
    return [a[r:r + rows] for r in range(0, a.shape[0], rows)]


def rel_err(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor | None = None
            ) -> tuple[float, float]:
    """(relative Frobenius error, max abs error) of a against b, in f64,
    over row chunks: an (M, N) f64 copy at ERA5 size would be 32 GB.
    The error is relative to |scale| where given, else to |b|."""
    num = den = max_abs = 0.0
    ref = b if scale is None else scale
    rows = _chunk_rows(a, b, ref)
    for ac, bc, sc in zip(_chunks(a, rows), _chunks(b, rows), _chunks(ref, rows)):
        diff = ac.double() - bc.double()
        num += float((diff * diff).sum())
        den += float(sc.double().square().sum())
        max_abs = max(max_abs, float(diff.abs().max()))
    return math.sqrt(num / max(den, 1e-300)), max_abs


def row_abs_sums(x: torch.Tensor) -> torch.Tensor:
    """sum_t |x[r, t]| per row, in f64, over row chunks."""
    return torch.cat([xc.double().abs().sum(dim=1) for xc in _chunks(x)])


def within_bf16_ulp(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Every entry of a within one bf16 ulp of b's (plus f32 roundoff
    slack where centring cancels), over row chunks.  The ulp of b is
    2^(floor(log2|b|) - 7), its exponent taken exactly (frexp): a
    floating log2 of a power of two may fall just below it."""
    top = float(b.abs().max())
    rows = _chunk_rows(a, b)
    for ac, bc in zip(_chunks(a, rows), _chunks(b, rows)):
        bd = bc.double()
        ulp = torch.exp2(torch.frexp(bd.abs().clamp_min(1e-30)).exponent.double() - 8)
        if not bool(((ac.double() - bd).abs() <= ulp + 2.0**-20 * top).all()):
            return False
    return True


def gram_f64(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """A^T B (B = A by default) in f64 over row chunks: the exact sums of
    the stored f32 matrices, against which the kernels are read."""
    b = a if b is None else b
    out = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float64, device=a.device)
    rows = _chunk_rows(a, b)
    for ac, bc in zip(_chunks(a, rows), _chunks(b, rows)):
        out += ac.double().T @ bc.double()
    return out


def compare_kernel(label, x, w, dtype, centred=False, **flags) -> dict:
    """K1 against its plain version on the card, on the same x and w.

    Tolerances: f32 outputs relative Frobenius error <= 1e-5; bf16 Yc
    within one bf16 ulp; the f32 stats <= 1e-5.  G and C: the plain
    version sums them in f32, which over millions of rows is itself off
    by up to ~1e-5 of |G|, so both are also read against the f64 sums of
    the plain version's stored Yc.  The kernel must be within 1e-5 of
    those and within 1e-5 plus the plain version's own error of the
    plain version.  With ``centred`` (x's rows already have zero mean)
    each row sum cancels to roundoff in both versions, where a relative
    error means nothing; the row sums are then read against the sum of
    their terms' magnitudes, sum_t |x|, the scale of a sum's forward
    error bound (for scalar stats, against sum_r (sum_t |x|)^2), and
    held to the same 1e-5.  On f32 operands a control, one TF32 pass
    (the library products Yc^T Yc and Yc^T X of the plain version's Yc
    with TF32 allowed, the flag restored), must miss the 1e-5 that G and
    C meet against the f64 sums.  Times are CUDA-event ms; outputs are
    freed before timing, as at ERA5 size each Yc is up to 16 GB.  Each
    stage's device ms (sketch, G, C) is read alone on the same buffers
    and kept in ``K1_STAGES``.
    """
    from dmd_era5_tpu_torch.ops.matmul import (
        _sketch_center_gram_project_plain,
        sketch_center_gram_project,
    )

    def kernel():
        return sketch_center_gram_project(x, w, out_dtype=dtype, **flags)

    def plain():
        return _sketch_center_gram_project_plain(x, w, out_dtype=dtype, **flags)

    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    names = ("yc", "rowsum", "rowsumsq", "G", "C")
    errs, max_abs = {}, {}
    for name, a, b in zip(names, got, ref):
        if b is None:
            continue
        scale = None
        if centred and name == "rowsum":
            scale = row_abs_sums(x)
            if flags.get("scalar_stats"):
                scale = scale.square().sum()
        errs[name], max_abs[name] = rel_err(a, b, scale)
    exact = {"G": gram_f64(ref[0]), "C": gram_f64(ref[0], x)}
    err_exact = {f"{v}_{name}_vs_f64": rel_err(out, exact[name])[0]
                 for name in exact
                 for v, out in (("kernel", got[names.index(name)]),
                                ("plain", ref[names.index(name)]))}
    bf16 = dtype == torch.bfloat16
    if not bf16:
        with one_tf32_pass():
            one_pass = {"G": ref[0].T @ ref[0], "C": ref[0].T @ x}
        for name, out in one_pass.items():
            err_exact[f"one_tf32_pass_{name}_vs_f64"] = rel_err(out, exact[name])[0]
            check(err_exact[f"one_tf32_pass_{name}_vs_f64"] > 1e-5,
                  f"{label}: one TF32 pass reads {name} within 1e-5 of the f64 sums: the "
                  "limit does not tell 3xTF32 from it")
        del one_pass
    if bf16:
        check(within_bf16_ulp(got[0], ref[0]), f"{label}: bf16 Yc beyond one ulp")
    for name, e in errs.items():
        if name in ("G", "C"):
            limit = 1e-5 + err_exact[f"plain_{name}_vs_f64"]
            e_k = err_exact[f"kernel_{name}_vs_f64"]
            check(e_k <= 1e-5, f"{label}: {name} relative error vs f64 sums {e_k:.3e} > 1e-5")
        elif name == "yc" and bf16:
            continue  # held to one ulp above
        else:
            limit = 1e-5
        check(e <= limit, f"{label}: {name} relative error {e:.3e} > {limit:.3e}")
    del got, ref, exact
    # turns: plain, kernel, kernel, plain
    p1, k1, k2, p2 = event_ms(plain), event_ms(kernel), event_ms(kernel), event_ms(plain)
    m, t = x.shape
    n = w.shape[1]
    bound_ms, bound_by = k1_bound(m, t, n, x.dtype, flags.get("scalar_stats", False))
    res = dict(label=label, m=m, t=t, n=n, dtype=str(dtype).replace("torch.", ""),
               flags=flags, centred=centred, rel_err=errs, **err_exact, max_abs_err=max_abs,
               ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound_ms, bound_by=bound_by,
               stage_device_ms=k1_stage_ms(x, w, dtype, flags))
    K1_STAGES.append(dict(label=label, m=m, t=t, n=n, dtype=res["dtype"], **res["stage_device_ms"]))
    log(f"    {json.dumps(res)}")
    return res


def k1_bound(m: int, t: int, n: int, dtype: torch.dtype, scalar_stats: bool
             ) -> tuple[float, str]:
    """K1's bound on the tensor cores: X W (2 m n t), the symmetric half of
    Yc^T Yc (m n (n + 1)) and Yc^T X (2 m n t), three TF32 passes of each
    for f32 operands, one bf16 pass for bf16; X and W read, Yc, the
    statistics, G and C written."""
    bf16 = dtype == torch.bfloat16
    size = 2 if bf16 else 4
    stats = 2 if scalar_stats else 2 * m
    return bound((1 if bf16 else 3) * m * n * (4 * t + n + 1), PEAK_BF16 if bf16 else PEAK_TF32,
                 size * (m * t + t * n + m * n) + 4 * (stats + n * n + n * t))


def k1_stage_ms(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype, flags: dict,
                reps: int = 5) -> dict:
    """Device ms of each of K1's stages alone (``chip_smoke.device_ms``),
    each launched through the wrapper's plan on one set of buffers after
    one whole call has filled them; not counted as launches."""
    from dmd_era5_tpu_torch.ops.matmul import _scgp_plan

    args = {key: flags.get(key, default) for key, default in (
        ("center", True), ("stats_col", False), ("scalar_stats", False), ("t_valid", None),
        ("emit_yc", True))}
    out, run = _scgp_plan(x, w, dtype, **args)
    run(7)
    times = {name: device_ms(lambda mask=mask: run(mask), reps)
             for name, mask in (("sketch", 1), ("G", 2), ("C", 4))}
    del out, run
    return times


def phase_kernel_vs_plain(seed: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    log("[2] K1 against its plain version, smoke shapes (relative Frobenius errors; "
        "CUDA-event ms)")
    shapes = [(1 << 19, 512, 128, dt, dict(center=True, scalar_stats=True, stats_col=sc))
              for dt in (torch.float32, torch.bfloat16) for sc in (False, True)]
    shapes.append((1 << 20, T_HOURS, 256, torch.float32, dict(center=False)))
    for m, t, n, dtype, flags in shapes:
        x = torch.randn((m, t), generator=gen, device="cuda").to(dtype)
        w = torch.randn((t, n), generator=gen, device="cuda").to(dtype)
        compare_kernel("smoke", x, w, dtype, **flags)
        del x, w


def phase_kernel_at_path_shapes(x: torch.Tensor, seed: int) -> dict:
    """K1 against its plain version on the slice's own X, with the sketch
    widths and flags the main path gives it: the Hankel pass (stacked W,
    N = 256, no centring, f32) and the fit step (N = 128, centring, scalar
    stats, f32 and bf16).  Run after the main path's launch count is read."""
    from dmd_era5_tpu_torch.ops.hankel import stacked_sketch_matrix

    log(f"[5] K1 against its plain version on the ERA5-week X {tuple(x.shape)} "
        "(rows centred: row sums read against sum_t |x|)")
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    t = x.shape[1]
    omega = torch.randn((t - 1, 128), generator=gen, device=x.device)
    hankel = compare_kernel("hankel_pass", x, stacked_sketch_matrix(omega, 2, t),
                            torch.float32, centred=True, center=False)
    omega = torch.randn((t, 128), generator=gen, device=x.device)
    compare_kernel("fit_step", x, omega, torch.float32, centred=True,
                   center=True, scalar_stats=True)
    xb = x.to(torch.bfloat16)
    compare_kernel("fit_step", xb, omega.to(torch.bfloat16), torch.bfloat16,
                   centred=True, center=True, scalar_stats=True)
    del xb
    log(f"    peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return hankel


def make_era5_week(seed: int):
    """X (S, 168) f32 on the card: one week of hourly 0.25-degree ERA5."""
    return make_era5(seed, N_LAT, N_LON, 0.25, T_HOURS, PAIRS)


def make_era5_year(seed: int):
    """X (S, 8760) f32 on the card: one year of hourly 1-degree ERA5."""
    return make_era5(seed, YEAR_LAT, YEAR_LON, YEAR_DEG, YEAR_HOURS, YEAR_PAIRS)


def make_era5(seed: int, n_lat: int, n_lon: int, deg: float, t_hours: int, pairs):
    """X (S, T) f32 on the card, S = 15 n_lat n_lon: per row the mock
    temperature recipe's mean, (265 - lapse) cos(latitude), plus the
    planted damped pairs with random complex patterns, plus noise at 1%
    of the signal's rms.  Rows are drawn in chunks of at most 2^20 rows
    and 1 GiB."""
    dev = torch.device("cuda")
    s_rows = N_BLOCKS * n_lat * n_lon
    chunk = min(CHUNK, max(1, GIB // (4 * t_hours)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    hours = torch.arange(t_hours, dtype=torch.float64, device=dev)
    alpha = torch.tensor([complex(d, 2 * math.pi / p) for d, p, _ in pairs],
                         dtype=torch.complex128, device=dev)
    amps = torch.tensor([a for *_, a in pairs], dtype=torch.float64, device=dev)

    def dynamics(h):
        return (amps[:, None] * torch.exp(alpha[:, None] * h[None, :])).to(torch.complex64)

    dyn = dynamics(hours)
    # Re(c e) with Re c, Im c ~ N(0, 1) has variance |e|^2
    signal_rms = float(torch.sqrt((dyn.abs() ** 2).sum(0).mean()))
    noise_std = NOISE_FRACTION * signal_rms
    x = torch.empty((s_rows, t_hours), dtype=torch.float32, device=dev)
    patterns = torch.empty((s_rows, len(pairs)), dtype=torch.complex64, device=dev)
    row_mean = torch.empty(s_rows, dtype=torch.float32, device=dev)
    levels = torch.tensor(LEVELS, dtype=torch.float32, device=dev)
    for r0 in range(0, s_rows, chunk):
        r1 = min(r0 + chunk, s_rows)
        rows = torch.arange(r0, r1, device=dev)
        lapse = (1000.0 - levels[(rows // (n_lat * n_lon)) % len(LEVELS)]) / 100.0
        lat = 90.0 - deg * ((rows // n_lon) % n_lat).float()
        row_mean[r0:r1] = (265.0 - lapse) * torch.cos(torch.deg2rad(lat))
        c = torch.complex(
            torch.randn((r1 - r0, len(pairs)), generator=gen, device=dev),
            torch.randn((r1 - r0, len(pairs)), generator=gen, device=dev),
        )
        patterns[r0:r1] = c
        x[r0:r1] = (
            row_mean[r0:r1, None]
            + c.real @ dyn.real - c.imag @ dyn.imag
            + noise_std * torch.randn((r1 - r0, t_hours), generator=gen, device=dev)
        )

    def truth(h):
        """Noise-free field (rows' mean plus planted signal) at hours h."""
        d = dynamics(h)
        return row_mean[:, None] + patterns.real @ d.real - patterns.imag @ d.imag

    planted = torch.cat([alpha, alpha.conj()]).to(torch.complex64)  # 6 eigenvalues
    return x, truth, row_mean, planted, noise_std


def matched_eig_error(found: torch.Tensor, true: torch.Tensor) -> float:
    """Greedy nearest matching of eigenvalue sets (tests/test_05_dmd.py)."""
    left = list(found.cpu().numpy())
    err = 0.0
    for tv in true.cpu().numpy():
        d = [abs(f - tv) for f in left]
        i = min(range(len(d)), key=d.__getitem__)
        err = max(err, d[i])
        left.pop(i)
    return err


def dmd_and_forecast(label: str, svd, week: dict, times: dict, d: int = 2) -> None:
    """optDMD (rank 6) on a Hankel SVD and a 24-step forecast past the
    window, held to the planted eigenvalues and the noise-free signal."""
    from dmd_era5_tpu_torch.models import optdmd_from_svd, rollout, undo_preprocessing

    rank, steps = 6, 24
    u, s, v = svd
    t_fit = torch.arange(v.shape[1], dtype=torch.float32, device=u.device)
    opt, times["optdmd"] = synced(optdmd_from_svd, u, s, v, t_fit, rank=rank)
    eig_err = matched_eig_error(opt.alpha, week["alpha_true"])
    log(f"    {label} optDMD: {opt.n_iters} LM steps, residual {float(opt.residual):.3e}, "
        f"alpha {[complex(round(a.real, 5), round(a.imag, 5)) for a in opt.alpha.cpu().tolist()]}, "
        f"matched error vs planted {eig_err:.2e}")
    check(len(week["alpha_true"]) == rank and eig_err < 1e-2,
          f"{label}: planted eigenvalues not recovered: matched error {eig_err:.3e}")

    # 24 hours past the window; embedded time i is hour i + d - 1
    t_fut = torch.arange(v.shape[1], v.shape[1] + steps, dtype=torch.float32, device=u.device)

    def forecast():
        return undo_preprocessing(rollout(opt, t_fut), week["mean"].repeat(d), None, delay=d)

    fc, times["forecast"] = synced(forecast)
    s_rows = week["x"].shape[0]
    check(fc.shape == (s_rows, steps), f"{label}: forecast shape {tuple(fc.shape)}")
    check(bool(torch.isfinite(fc).all()), f"{label}: forecast has non-finite values")
    ref = week["truth"](t_fut.double() + d - 1)
    fc_err = float((fc - ref).norm() / (ref - week["row_mean"][:, None]).norm())
    log(f"    {label} forecast {tuple(fc.shape)}: relative error of the anomaly vs the "
        f"noise-free planted signal {fc_err:.3e}")
    check(fc_err < 5e-2, f"{label}: forecast relative error {fc_err:.3e} >= 5e-2")


def phase_slice(seed: int) -> dict:
    """Phase 3.  Returns the week: the centred X, its row means, the
    noise-free truth, the planted eigenvalues and the randomized s."""
    from dmd_era5_tpu_torch.ops import hankel_randomized_svd_fused
    from dmd_era5_tpu_torch.snapmat import standardize_data

    d, k = 2, 100
    torch.cuda.reset_peak_memory_stats()
    (x, truth, row_mean, alpha_true, noise_std), t_gen = synced(make_era5_week, seed)
    log(f"[3] ERA5 week X {tuple(x.shape)} f32 ({x.numel() * 4 / 1e9:.2f} GB) generated "
        f"in {t_gen:.2f} s; noise std {noise_std:.4f}")
    times = {"generate": t_gen}

    (x, mean, _), times["center"] = synced(standardize_data, x, scale=False)
    week = dict(x=x, mean=mean, truth=truth, row_mean=row_mean, alpha_true=alpha_true)
    before = launch_counts()["K1"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    svd, times["hankel_svd"] = synced(
        hankel_randomized_svd_fused, x, d, k, generator=gen, gemm_dtype=torch.float32
    )
    svd_launches = launch_counts()["K1"] - before
    check(svd_launches == 5, f"Hankel SVD launched K1 {svd_launches} times, expected 5")
    u, s, v = svd
    gram = u.T @ u
    orth = float((gram - torch.eye(k, device=u.device)).abs().max())
    check(orth <= 1e-3, f"U^T U - I max {orth:.3e} > 1e-3")
    check(bool((s > 0).all()) and bool((s[1:] <= s[:-1]).all()), "s not positive descending")
    log(f"    SVD: U {tuple(u.shape)}, max|U^T U - I| {orth:.2e}, s[:8] "
        f"{[round(float(a), 2) for a in s[:8]]}, K1 launches {svd_launches}")
    dmd_and_forecast("randomized", svd, week, times, d)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"    stage wall times (s): {json.dumps({a: round(b, 3) for a, b in times.items()})}; "
        f"peak device memory {peak:.2f} GB")
    week["s_rand"] = s.clone()
    del u, s, v, svd, gram
    return week


def phase_fit_step(x: torch.Tensor, seed: int) -> None:
    from dmd_era5_tpu_torch.pipeline import fit_step_fused

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    omega = torch.randn((x.shape[1], 128), generator=gen, device=x.device)
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 1e-2)):
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()["K1"]
        state, secs = synced(fit_step_fused, x, omega, 100, gemm_dtype=dtype)
        launches = launch_counts()["K1"] - before
        check(launches == 1, f"fit step launched K1 {launches} times, expected 1")
        check(bool(torch.isfinite(state.loss)), "fit step loss not finite")
        # the leading components are the planted rank; the other 94 sit at
        # the noise floor (cond(G) ~ 2e7), held to the JAX tests' bound for
        # all components of a bf16 fit (tests/test_07_train_step.py:212)
        gram = state.u.float().T @ state.u.float()
        dev = (gram - torch.eye(gram.shape[0], device=x.device)).abs()
        lead = len(PAIRS) * 2
        orth = float(dev[:lead, :lead].max())
        check(orth <= tol, f"{dtype} fit step: leading U^T U - I max {orth:.3e} > {tol}")
        check(float(dev.max()) <= 1.5e-1, f"{dtype} fit step: U^T U - I max {float(dev.max()):.3e}")
        log(f"[4] fit_step_fused {str(dtype)[6:]}: {secs:.3f} s, loss {float(state.loss):.4e}, "
            f"s[:8] {[round(float(a), 2) for a in state.s[:8]]}, max|U^T U - I| leading "
            f"{lead} {orth:.2e} (all 100: {float(dev.max()):.2e}), K1 launches {launches}, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del state


def compare_gram(label: str, a: torch.Tensor, precision: str, exact: torch.Tensor | None = None,
                 reps: int = 3) -> dict:
    """K4 or K5 against its plain version and the f64 sums of A^T A.

    Tolerances: ``"highest"`` within 1e-6 relative Frobenius error of the
    f64 sums, which on f32 A one TF32 pass (the library product with TF32
    allowed, the control) must miss; ``"bf16_split"`` within
    3e-5 max|G| of them (tests/test_25_linalg.py:102: the split drops
    L^T L and rounds L to bf16, ~1e-6 relative).  Against the plain
    version, whose f32 library sums over millions of rows are off by up
    to ~1e-5 themselves: within the kernel's own limit plus the plain
    version's error.  G must be exactly symmetric.  Times are CUDA-event
    ms in turns plain, kernel, kernel, plain; the library call is one f32
    ``a.T @ a`` (TF32 off), which the port never makes.  With ``exact``
    given (the f64 sums, formed by the caller) there is no plain version:
    at the year its f32 copies of H and L (2 x 34 GB) do not fit beside
    A, and ``plain_ms`` is None."""
    from dmd_era5_tpu_torch.ops.qr_panel import _gram_plain, gram

    def kernel():
        return gram(a, precision)

    def plain():
        return _gram_plain(a, precision)

    def library():
        return a.T @ a

    with_plain = exact is None
    exact = gram_f64(a) if exact is None else exact
    got = kernel()
    torch.cuda.synchronize()
    check(torch.equal(got, got.T), f"{label} {precision}: G not exactly symmetric")
    scale = float(exact.abs().max())
    res = dict(label=label, precision=precision, m=a.shape[0], k=a.shape[1])
    res["kernel_rel_vs_f64"] = rel_err(got, exact)[0]
    res["kernel_max_abs_vs_f64_over_max"] = float((got.double() - exact).abs().max()) / scale
    if with_plain:
        ref = plain()
        res["plain_rel_vs_f64"] = rel_err(ref, exact)[0]
        res["plain_max_abs_vs_f64_over_max"] = float((ref.double() - exact).abs().max()) / scale
        res["rel_vs_plain"], res["max_abs_err"] = rel_err(got, ref)
        del ref
    else:
        res["max_abs_err"] = float((got.double() - exact).abs().max())
    if precision == "highest":
        limit = 1e-6
        check(res["kernel_rel_vs_f64"] <= limit,
              f"{label} K4: G relative error vs f64 {res['kernel_rel_vs_f64']:.3e} > {limit}")
        if a.dtype == torch.float32:
            with one_tf32_pass():
                res["one_tf32_pass_rel_vs_f64"] = rel_err(a.T @ a, exact)[0]
            check(res["one_tf32_pass_rel_vs_f64"] > limit,
                  f"{label} K4: one TF32 pass reads {res['one_tf32_pass_rel_vs_f64']:.3e}, within "
                  f"{limit}: the limit does not tell 3xTF32 from it")
    else:
        limit = 3e-5
        check(res["kernel_max_abs_vs_f64_over_max"] <= limit,
              f"{label} K5: G max error vs f64 {res['kernel_max_abs_vs_f64_over_max']:.3e} "
              f"max|G| > {limit}")
    if with_plain:
        if precision == "highest":
            limit_plain = limit + res["plain_rel_vs_f64"]
            got_plain = res["rel_vs_plain"]
        else:
            limit_plain = limit + res["plain_max_abs_vs_f64_over_max"]
            got_plain = res["max_abs_err"] / scale
        check(got_plain <= limit_plain,
              f"{label} {precision}: kernel vs plain {got_plain:.3e} > {limit_plain:.3e}")
    del got, exact
    if with_plain:
        p1, k1, k2, p2 = (event_ms(f, reps) for f in (plain, kernel, kernel, plain))
        res.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
    else:
        res.update(ms=event_ms(kernel, reps), plain_ms=None)
    res["library_ms"] = event_ms(library, reps)
    m, k = a.shape
    size = a.element_size()
    if precision == "highest":  # the symmetric half: 3xTF32 on f32 A, one bf16 pass on bf16 A
        bf16 = a.dtype == torch.bfloat16
        res["bound_ms"], res["bound_by"] = bound(
            (1 if bf16 else 3) * m * k * (k + 1), PEAK_BF16 if bf16 else PEAK_TF32,
            size * m * k + 4 * k * k)
    else:  # H^T H (symmetric half) and H^T L, both bf16 products
        res["bound_ms"], res["bound_by"] = bound(
            m * k * (k + 1) + 2 * m * k * k, PEAK_BF16, size * m * k + 4 * k * k)
    log(f"    {json.dumps(res)}")
    return res


def phase_gram_vs_plain(x: torch.Tensor, seed: int) -> dict:
    """Phase 6: K4 and K5 on the centred ERA5-week X and on an f32 sketch
    Y = X Omega (S x 110, the randomized route's panel)."""
    log(f"[6] K4 and K5 against their plain versions and the f64 sums, on X {tuple(x.shape)} "
        "and its sketch Y (S x 110)")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    y = x @ torch.randn((x.shape[1], 110), generator=gen, device=x.device)
    out = {(name, p): compare_gram(name, a, p)
           for name, a in (("X", x), ("Y", y)) for p in ("highest", "bf16_split")}
    del y
    log(f"    peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out


def orthonormality(u: torch.Tensor) -> float:
    """max |U^T U - I|, U^T U summed in f64."""
    g = gram_f64(u)
    return float((g - torch.eye(g.shape[0], dtype=g.dtype, device=g.device)).abs().max())


def subspace_cos_min(u1: torch.Tensor, u2: torch.Tensor) -> float:
    """Cosine of the largest principal angle between span(U1) and
    span(U2): the least singular value of Q1^T Q2 with Q_i = U_i L_i^-T
    orthonormal (L_i L_i^T = U_i^T U_i, all in f64), so the columns'
    own f32 departure from orthonormality does not count as an angle."""
    l1 = torch.linalg.cholesky(gram_f64(u1))
    l2 = torch.linalg.cholesky(gram_f64(u2))
    m = torch.linalg.solve_triangular(l1, gram_f64(u1, u2), upper=False)
    m = torch.linalg.solve_triangular(l2, m.T, upper=False).T
    return float(torch.linalg.svdvals(m).min())


def check_interlace(label: str, s_rand: torch.Tensor, s_exact: torch.Tensor) -> dict:
    """Rayleigh-Ritz values of a sketched subspace stay below the exact
    singular values: s_rand <= s_exact (1 + 1e-4); the planted 6, well
    above the noise floor, agree to 1e-4."""
    ratio = (s_rand.double() / s_exact.double()).cpu()
    lead = float((ratio[:6] - 1).abs().max())
    check(float(ratio.max()) <= 1 + 1e-4,
          f"{label}: randomized s above exact s, max ratio {float(ratio.max()):.8f}")
    check(lead <= 1e-4, f"{label}: leading 6 singular values differ by {lead:.3e} > 1e-4")
    return {"max_ratio": float(ratio.max()), "at": int(ratio.argmax()),
            "min_ratio": float(ratio.min()), "lead6_rel": lead}


def phase_standard(week: dict) -> dict:
    """Phase 7: the svd_type = standard path, exact Hankel SVD (d = 2,
    k = 100; K5 once, K1 once) -> optDMD -> forecast."""
    from dmd_era5_tpu_torch.ops import hankel_exact_svd

    d, k = 2, 100
    x = week["x"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = {}
    svd, times["hankel_exact_svd"] = synced(hankel_exact_svd, x, d, k)
    u, s, v = svd
    orth = orthonormality(u)
    check(orth <= 1e-3, f"exact Hankel SVD: U^T U - I max {orth:.3e} > 1e-3")
    check(bool((s > 0).all()) and bool((s[1:] <= s[:-1]).all()), "s not positive descending")
    log(f"[7] exact Hankel SVD: U {tuple(u.shape)}, max|U^T U - I| {orth:.2e}, s[:8] "
        f"{[round(float(a), 2) for a in s[:8]]}")
    inter = check_interlace("phase 3 vs exact Hankel", week["s_rand"], s)
    log(f"    randomized s (phase 3) / exact s: {json.dumps(inter)}")
    dmd_and_forecast("standard", svd, week, times, d)
    launches = launch_counts()
    check(launches == counts(K1=1, K5=1),
          f"standard path launches {launches}, expected K1 1, K5 1, no other")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"    stage wall times (s): {json.dumps({a: round(b, 3) for a, b in times.items()})}; "
        f"launches {launches}; peak device memory {peak:.2f} GB")
    del u, s, v, svd
    return launches


def phase_truncated(x: torch.Tensor, seed: int) -> tuple[dict, dict]:
    """Phase 8: truncated_svd at d = 1 by its four routes, each a main-path
    run of its own with exact launch counts; U orthonormal to 1e-3; the
    three exact routes held to one another (s: leading 6 to 1e-5, all 100
    to 2e-3, the tolerance of tests/test_03_svd.py:158,182; leading-6
    subspaces to 1 - 1e-6) and the randomized s below the exact s.

    The TSQR route (c) is the exception, a known fault of the reference
    (ROADMAP Queue 3).  Row centring makes X 1 = 0, so X is
    rank-deficient: outside the range of the split CholQR2 leaf, the JAX
    package's accelerator default (dmd_era5_tpu/ops/qr_panel.py:200-202:
    cond(X) well below 1/sqrt(eps_f32)).  Q's null column leaves the
    second Gram pass nearly singular, which amplifies the split Gram's
    ~1e-6 error in every direction (the JAX leaf does the same).  The
    leaf is kept, and (c) is held to a bracket around its own readings,
    ``TSQR_CENTRED_FAULT``, so that a fix and a further loss both fail
    the run; its readings are logged above the checks.

    Returns the launch counts and route (b)'s s and leading 6 columns of
    U, against which phase 9 holds the streamed routes."""
    from dmd_era5_tpu_torch.ops import truncated_svd

    k = 100
    routes = [
        ("a gram bf16_split", dict(svd_type="standard"), counts(K1=1, K5=1)),
        ("b gram highest", dict(svd_type="standard", gram_precision="highest"),
         counts(K1=1, K4=1)),
        ("c tsqr", dict(svd_type="standard", exact_method="tsqr"), counts(K5=2)),
        ("d randomized", dict(svd_type="randomized", seed=seed + 5), counts(K5=10)),
    ]
    total = dict.fromkeys(KERNELS, 0)
    s_of, lead_u, orth_of = {}, {}, {}
    for label, kwargs, expect in routes:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (u, s, v), secs = synced(truncated_svd, x, k, **kwargs)
        launches = launch_counts()
        check(launches == expect, f"truncated_svd {label}: launches {launches}, expected {expect}")
        for key, n in launches.items():
            total[key] += n
        check(u.shape == (x.shape[0], k) and v.shape == (k, x.shape[1]),
              f"truncated_svd {label}: shapes {tuple(u.shape)}, {tuple(v.shape)}")
        orth_of[label] = orthonormality(u)
        s_of[label] = s.clone()
        if not label.startswith("d"):
            lead_u[label] = u[:, :6].clone()
        log(f"[8] truncated_svd {label}: {secs:.3f} s, max|U^T U - I| {orth_of[label]:.2e}, "
            f"s[:8] {[round(float(a), 2) for a in s[:8]]}, s[-1] {float(s[-1]):.3f}, launches "
            f"{launches}, peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del u, s, v
    # every route's readings are logged above before any is held to its limits
    exact = [label for label, *_ in routes if not label.startswith("d")]
    ref = exact[0]
    pairs = {}
    for other in exact[1:]:
        rel = (s_of[other].double() / s_of[ref].double() - 1).abs()
        pairs[other] = (float(rel[:6].max()), float(rel.max()),
                        subspace_cos_min(lead_u[ref], lead_u[other]))
        log(f"    {other} vs {ref}: s rel diff leading 6 {pairs[other][0]:.2e}, all 100 "
            f"{pairs[other][1]:.2e}; leading-6 subspace cos min 1 - {1 - pairs[other][2]:.2e}")
    rand = routes[3][0]
    tsqr_route = routes[2][0]
    fault = "known fault, split CholQR2 leaf on row-centred X (ROADMAP Queue 3)"
    for label, orth in orth_of.items():
        s = s_of[label]
        if label == tsqr_route:
            lo, hi = TSQR_CENTRED_FAULT["orth"]
            check(lo < orth <= hi, f"truncated_svd {label}: {fault}: U^T U - I max {orth:.3e} "
                  f"outside ({lo}, {hi}]: the fault is fixed or worse")
        else:
            check(orth <= 1e-3, f"truncated_svd {label}: U^T U - I max {orth:.3e} > 1e-3")
        check(bool((s > 0).all()) and bool((s[1:] <= s[:-1]).all()),
              f"truncated_svd {label}: s not positive descending")
    for other, (lead, every, cos) in pairs.items():
        limit = 1e-5
        if other == tsqr_route:
            limit = TSQR_CENTRED_FAULT["lead6"]
            other = f"{other} ({fault})"
        check(lead <= limit, f"{other} vs {ref}: leading 6 s differ by {lead:.3e} > {limit}")
        check(every <= 2e-3, f"{other} vs {ref}: s differ by {every:.3e} > 2e-3")
        check(cos > 1 - 1e-6, f"{other} vs {ref}: leading-6 subspaces cos min {cos:.9f}")
    log(f"    randomized s / exact s ({ref}): "
        f"{json.dumps(check_interlace('randomized vs exact', s_of[rand], s_of[ref]))}")
    ref_b = routes[1][0]
    return total, {"s": s_of[ref_b], "u6": lead_u[ref_b]}


def compare_matmul(label: str, x: torch.Tensor, w: torch.Tensor, f64_gate: bool) -> dict:
    """K6 against its plain version, the f64 product and the library on
    the card, on the same x and w.

    Tolerances: relative Frobenius error <= 1e-5 of the plain version's
    out -- both sum f32-faithful products (3xTF32 against full f32; bf16
    x bf16 is exact in f32) over K = 168 terms, in another order.  Against
    the f64 product of the stored operands (max error over max|out|): where
    ``f64_gate`` (f32 operands: the streamed block and the ragged tail),
    K6's at most ``K6_F64_FACTOR`` times the plain f32 product's in this
    run, and a control, one TF32 pass (``torch.mm`` with TF32 allowed, the
    flag restored), above that limit, so that it tells 3xTF32 from one
    pass.  Times: ``ms`` is the wrapper's, calls issued back to back
    (CUDA events), ``device_ms`` the kernel's alone (``device_ms``: its
    launches queued behind a sleep of the card), and the same pair for
    the library call.  Library call: one ``torch.mm`` in f32 (TF32 off), or for bf16 operands
    ``torch.mm(..., out_dtype=torch.float32)`` where the installed torch has
    it (else none); the port never makes it.  Bound: 3xTF32, three
    tensor-core passes of 2MKN, for f32 operands; one bf16 pass for bf16."""
    from dmd_era5_tpu_torch.ops.matmul import _matmul_plain, matmul

    def kernel():
        return matmul(x, w)

    def plain():
        return _matmul_plain(x, w, torch.float32)

    bf16 = x.dtype == torch.bfloat16

    def library():
        return torch.mm(x, w, out_dtype=torch.float32) if bf16 else torch.mm(x, w)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    rel, max_abs = rel_err(got, ref)
    check(rel <= 1e-5, f"{label}: K6 relative error {rel:.3e} > 1e-5")
    w64 = w.double()
    exact = torch.cat([xc.double() @ w64 for xc in _chunks(x)])
    scale = float(exact.abs().max())

    def vs_f64(out: torch.Tensor) -> float:
        return float((out.double() - exact).abs().max()) / scale

    (m, k), n = x.shape, w.shape[1]
    res = dict(label=label, m=m, k=k, n=n, dtype=str(x.dtype)[6:], rel_err=rel,
               max_abs_err=max_abs, kernel_vs_f64_over_max=vs_f64(got),
               plain_vs_f64_over_max=vs_f64(ref))
    del got, ref
    if f64_gate:
        saved = torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            res["one_tf32_pass_vs_f64_over_max"] = vs_f64(torch.mm(x, w))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        limit = K6_F64_FACTOR * res["plain_vs_f64_over_max"]
        check(res["kernel_vs_f64_over_max"] <= limit,
              f"{label} K6: out vs f64 {res['kernel_vs_f64_over_max']:.3e} max|out| > "
              f"{K6_F64_FACTOR} x the plain f32 product's ({limit:.3e})")
        check(res["one_tf32_pass_vs_f64_over_max"] > limit,
              f"{label} K6: one TF32 pass reads {res['one_tf32_pass_vs_f64_over_max']:.3e} "
              f"max|out|, within {limit:.3e}: the limit does not tell 3xTF32 from it")
    del exact
    try:
        library()
    except (RuntimeError, TypeError, NotImplementedError):
        library_ms = library_device_ms = None
    else:
        library_ms, library_device_ms = event_ms(library, reps=20), device_ms(library)
    p1, k1, k2, p2 = (event_ms(f, reps=20) for f in (plain, kernel, kernel, plain))
    size = x.element_size()
    bound_ms, bound_by = bound((1 if bf16 else 3) * 2 * m * k * n, PEAK_BF16 if bf16 else PEAK_TF32,
                               size * (m * k + k * n) + 4 * m * n)
    res.update(ms=(k1 + k2) / 2, device_ms=device_ms(kernel), plain_ms=(p1 + p2) / 2,
               library_ms=library_ms, library_device_ms=library_device_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"    {json.dumps(res)}")
    for key in ("ms", "device_ms"):
        check(res[key] >= bound_ms, f"{label} K6: {key} {res[key]:.4f} below its bound {bound_ms:.4f}")
    return res


def library_device_ms(fn) -> float | None:
    """``device_ms`` of a library call, or None where the call waits for
    the card itself, so that the host never gets ahead of it."""
    try:
        return device_ms(fn)
    except AssertionError:
        return None


def compare_householder(label: str, a: torch.Tensor, gate_q: bool = True) -> dict:
    """K7 against its plain version (the same column sweep in torch ops)
    and the library QR on the card.

    Tolerances: R's entries within 1e-5 of max|R| of the plain version's
    (the same arithmetic summed in another order); max|Q^T Q - I| <= 1e-4
    (tests/test_08_kernels.py:255) and |QR - A| / |A| <= 1e-5 (backward
    stability).  Where ``gate_q`` (a Gaussian panel, cond < 10) Q within
    5e-5 of the plain version's in relative Frobenius norm; not on an
    ill-conditioned panel, whose trailing columns of Q the two orders of
    summation may turn apart within the orthogonality gate.  Library
    call: ``torch.linalg.qr`` with the diag(R) >= 0 flip; its
    orthogonality and reconstruction are logged beside the kernel's.
    Times: ``ms`` the wrapper's, calls back to back (CUDA events);
    ``device_ms`` the kernel's alone (its launches queued behind a sleep
    of the card), the same pair for the library; ``ctas`` the CTAs the
    wrapper chose."""
    from dmd_era5_tpu_torch.ops.qr_panel import (
        _householder_limits, _householder_plain, householder_panel, householder_shares)
    from dmd_era5_tpu_torch.ops.tsqr import qr_positive

    def kernel():
        return householder_panel(a)

    def plain():
        q, r = _householder_plain(a)
        signs = torch.where(torch.diagonal(r) < 0, -1.0, 1.0)
        return q * signs, r * signs[:, None]

    def library():
        return qr_positive(a)

    (q, r), (q_p, r_p), (q_l, r_l) = kernel(), plain(), library()
    torch.cuda.synchronize()
    m, n = a.shape
    eye = torch.eye(n, dtype=torch.float64, device=a.device)
    a64 = a.double()
    res = dict(label=label, m=m, n=n,
               ctas=len(householder_shares(m, n, *_householder_limits(a.device))))
    for who, qq, rr in (("kernel", q, r), ("plain", q_p, r_p), ("library", q_l, r_l)):
        res[f"{who}_orth"] = float((qq.double().T @ qq.double() - eye).abs().max())
        res[f"{who}_recon"] = float((qq.double() @ rr.double() - a64).norm() / a64.norm())
    r_err = float((r - r_p).abs().max()) / float(r_p.abs().max())
    q_rel = float((q.double() - q_p.double()).norm() / q_p.double().norm())
    res.update(r_max_abs_over_max=r_err, q_rel=q_rel,
               max_abs_err=max(float((q - q_p).abs().max()), float((r - r_p).abs().max())))
    check(res["kernel_orth"] <= 1e-4, f"{label}: K7 Q^T Q - I max {res['kernel_orth']:.3e} > 1e-4")
    check(res["kernel_recon"] <= 1e-5, f"{label}: K7 |QR - A|/|A| {res['kernel_recon']:.3e} > 1e-5")
    check(r_err <= 1e-5, f"{label}: K7 R vs plain {r_err:.3e} of max|R| > 1e-5")
    if gate_q:
        check(q_rel <= 5e-5, f"{label}: K7 Q vs plain relative {q_rel:.3e} > 5e-5")
    del q, r, q_p, r_p, q_l, r_l
    p1, k1, k2, p2 = (event_ms(f, reps=r) for f, r in ((plain, 3), (kernel, 20), (kernel, 20), (plain, 3)))
    # Householder QR with Q formed: 4 m n^2 - 4 n^3 / 3 flops in f32; A
    # read once, Q and R written once
    bound_ms, bound_by = bound(4 * m * n * n - 4 * n**3 / 3, PEAK_F32, 4 * (2 * m * n + n * n))
    res.update(ms=(k1 + k2) / 2, device_ms=device_ms(kernel), plain_ms=(p1 + p2) / 2,
               library_ms=event_ms(library, reps=20), library_device_ms=library_device_ms(library),
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"    {json.dumps(res)}")
    for key in ("ms", "device_ms"):
        check(res[key] >= bound_ms, f"{label} K7: {key} {res[key]:.4f} below its bound {bound_ms:.4f}")
    return res


def phase_streamed_kernels(x: torch.Tensor, seed: int) -> dict:
    """Phase 9a: K6 on the first and the ragged last row block of X with a
    (168, 110) orthonormal iterate, in f32 and with bf16 operands; K7 on
    the iterate's (168, 110) shape and its envelope's two edges."""
    from dmd_era5_tpu_torch.ops.tsqr import qr_positive

    n_rows = x.shape[0]
    tail = n_rows % RAND_BLOCK
    log(f"[9a] K6 and K7 against their plain versions (block {RAND_BLOCK} rows, ragged tail "
        f"{tail}; CUDA-event ms)")
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    blk = x[:RAND_BLOCK]
    omega = torch.randn((x.shape[1], R_SKETCH), generator=gen, device=x.device)
    z = qr_positive(blk.T @ (blk @ omega))[0].contiguous()
    out = {"f32": compare_matmul("block f32", blk, z, f64_gate=True),
           "bf16": compare_matmul("block bf16", blk.bfloat16(), z.bfloat16(), f64_gate=False),
           "tail": compare_matmul("ragged tail f32", x[n_rows - tail:], z, f64_gate=True)}
    for m, n in ((x.shape[1], R_SKETCH), (8760, 110), (4096, 256)):
        panel = torch.randn((m, n), generator=gen, device=x.device)
        out[(m, n)] = compare_householder(f"panel {m}x{n}", panel)
    return out


def write_artifact(x: torch.Tensor, directory: Path) -> tuple[Path, float]:
    """Phase 9b: X from the card to a packed .npy artifact, chunk by
    chunk.  Fails when the directory lacks room for it."""
    from dmd_era5_tpu_torch.snapmat.loader import packed_info, save_packed_matrix

    path = directory / "era5_week_x.npy"
    need = x.numel() * x.element_size()
    free = shutil.disk_usage(directory).free
    log(f"[9b] artifact {path}: {need / 1e9:.2f} GB to write, {free / 1e9:.2f} GB free there")
    check(free >= need + GIB, f"no room for the {need / 1e9:.2f} GB artifact in {directory} "
          f"({free / 1e9:.2f} GB free); point TMPDIR at a larger disk")
    shape, secs = synced(save_packed_matrix, path, x)
    check(packed_info(path) == (tuple(x.shape), False) and shape == tuple(x.shape),
          f"artifact shape {shape}")
    log(f"    written in {secs:.2f} s ({need / secs / 1e9:.2f} GB/s), {path.stat().st_size} bytes")
    return path, secs


@contextlib.contextmanager
def pass_clock():
    """Wall time of each pass over the artifact, into the yielded list:
    wraps the streamed module's block reader, from its first block to
    the card's finishing the work of its last."""
    from dmd_era5_tpu_torch.pipeline import streamed_fit

    reader, times = streamed_fit.prefetched_row_blocks, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        yield from reader(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    streamed_fit.prefetched_row_blocks = timed
    try:
        yield times
    finally:
        streamed_fit.prefetched_row_blocks = reader


def streamed_run(label: str, fn, *args, **kwargs):
    """(result, seconds, per-pass seconds, device-memory rise) of one
    streamed SVD call, the rise over what was allocated when it began."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with pass_clock() as passes:
        res, secs = synced(fn, *args, **kwargs)
    rise = torch.cuda.max_memory_allocated() - base
    log(f"    {label}: {secs:.2f} s, passes (s) {[round(t, 3) for t in passes]}, "
        f"device memory rise {rise / 1e6:.1f} MB")
    check(rise <= GIB, f"{label}: device memory rose {rise / 1e9:.2f} GB > 1 GiB: not out of core")
    return res, secs, passes, rise


def held_to_exact(label: str, s: torch.Tensor, ref: dict) -> dict:
    """Leading 6 singular values within 1e-5 of phase 8 (b)'s."""
    rel = (s.double().cpu() / ref["s"].double().cpu() - 1).abs()
    out = {"lead6_rel": float(rel[:6].max()), "all_rel": float(rel.max())}
    check(out["lead6_rel"] <= 1e-5,
          f"{label}: leading 6 s differ from phase 8 (b) by {out['lead6_rel']:.3e} > 1e-5")
    return out


def phase_streamed(week: dict, ref8: dict, seed: int) -> dict:
    """Phase 9b-e: the out-of-core SVD of the centred ERA5-week X from a
    packed artifact, both routes, and optDMD with the forecast on the
    randomized one.  Returns the main path's launch counts."""
    from dmd_era5_tpu_torch.pipeline import (
        prefetched_row_blocks,
        streamed_exact_gram_svd,
        streamed_randomized_svd,
    )

    x = week["x"]
    n_rows, t_cols = x.shape
    n_blocks = -(-n_rows // RAND_BLOCK)
    times = {}
    directory = Path(tempfile.mkdtemp(prefix="dmd_era5_streamed_"))
    try:
        path, times["artifact_write"] = write_artifact(x, directory)

        log(f"[9c] streamed_randomized_svd(k = 100): {n_blocks} blocks of {RAND_BLOCK} rows "
            "per pass, n_iter auto")
        reset_counts()
        res, times["streamed_randomized"], passes, rise_r = streamed_run(
            "randomized", streamed_randomized_svd, path, 100, seed=seed + 7)
        times["randomized_passes"] = passes
        check(len(passes) == 6, f"randomized route read the artifact {len(passes)} times, not 6")
        u = torch.from_numpy(res.U).cuda()
        s, v = res.s, res.V
        del res
        orth = orthonormality(u)
        check(orth <= 1e-3, f"streamed randomized: U^T U - I max {orth:.3e} > 1e-3")
        lead = held_to_exact("streamed randomized", s, ref8)
        inter = check_interlace("streamed randomized vs phase 8 (b)", s, ref8["s"])
        log(f"    U {tuple(u.shape)} on the host, max|U^T U - I| {orth:.2e}, s[:8] "
            f"{[round(float(a), 2) for a in s[:8]]}; vs phase 8 (b): {json.dumps(lead)}, "
            f"{json.dumps(inter)}")
        log("[9e] optDMD (rank 6) and a 24-step forecast on the streamed randomized SVD (d = 1)")
        dmd_and_forecast("streamed", (u, s, v), week, times, d=1)
        launches = launch_counts()
        expect = counts(K6=5 * n_blocks, K7=4)
        check(launches == expect, f"streamed randomized path launches {launches}, expected {expect}")
        log(f"    launches {launches}")
        del u, s, v

        log(f"[9d] streamed_exact_gram_svd(k = 100): {-(-n_rows // EXACT_BLOCK)} blocks of "
            f"{EXACT_BLOCK} rows per pass")
        reset_counts()
        res, times["streamed_exact"], times["exact_passes"], rise_e = streamed_run(
            "exact", streamed_exact_gram_svd, path, 100, block_rows=EXACT_BLOCK)
        check(launch_counts() == counts(), f"exact streamed route launched {launch_counts()}")
        u = torch.from_numpy(res.U).cuda()
        s_e = torch.from_numpy(res.s)
        del res
        # U = X V S^-1 carries the f32 per-block Gram's error over s_i s_j
        # into its noise-floor columns: held to 1e-2, its own reading logged
        orth = orthonormality(u)
        check(orth <= 1e-2, f"streamed exact: U^T U - I max {orth:.3e} > 1e-2")
        lead = held_to_exact("streamed exact", s_e, ref8)
        cos = subspace_cos_min(u[:, :6], ref8["u6"])
        log(f"    max|U^T U - I| {orth:.2e}, s[:8] {[round(float(a), 2) for a in s_e[:8]]}; "
            f"vs phase 8 (b): {json.dumps(lead)}, leading-6 subspace cos min 1 - {1 - cos:.2e}")
        check(lead["all_rel"] <= 2e-3, f"streamed exact: s differ from phase 8 (b) by "
              f"{lead['all_rel']:.3e} > 2e-3")
        check(cos > 1 - 1e-6, f"streamed exact: leading-6 subspace cos min {cos:.9f}")
        del u

        # where a pass's time goes: the same blocks read only, then read and
        # copied to the card, with no work on them
        t0 = time.perf_counter()
        for _ in prefetched_row_blocks(path, n_rows, RAND_BLOCK):
            pass
        times["pass_read_only"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _, blk in prefetched_row_blocks(path, n_rows, RAND_BLOCK):
            torch.from_numpy(blk).to("cuda")
        torch.cuda.synchronize()
        times["pass_read_and_copy"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    times["memory_rise_mb"] = {"randomized": rise_r / 1e6, "exact": rise_e / 1e6}
    log(f"    stage wall times (s): {json.dumps(times)}")
    return expect


def compare_sketch_center_gram(label: str, x: torch.Tensor, w: torch.Tensor, center: bool,
                               out_dtype: torch.dtype = torch.float32) -> tuple[dict, torch.Tensor]:
    """K2 against its plain version on the card, on the same x and w
    (both f32 or both bf16), Yc in ``out_dtype``.  Tolerances: an f32 Yc
    within 1e-5 relative Frobenius error of the plain version's, a bf16
    Yc within one bf16 ulp of it; the row sums of squares within 1e-5;
    the row sums read against sum_t |x| (x's rows are centred, so the
    sums cancel to roundoff); G exactly symmetric and within 1e-5 max|G|
    of the f64 sums of the kernel's own stored Yc, and within that plus
    the plain version's own error of the plain version.  No single
    library call computes this function.  Returns the readings and the
    kernel's Yc."""
    from dmd_era5_tpu_torch.ops.matmul import _sketch_center_gram_plain, sketch_center_gram

    def kernel():
        return sketch_center_gram(x, w, out_dtype=out_dtype, center=center)

    def plain():
        return _sketch_center_gram_plain(x, w, out_dtype, center)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(torch.equal(got[3], got[3].T), f"{label} K2: G not exactly symmetric")
    res = dict(label=label, m=x.shape[0], t=x.shape[1], n=w.shape[1], center=center,
               dtype=str(x.dtype).replace("torch.", ""),
               out_dtype=str(out_dtype).replace("torch.", ""))
    res["yc_rel"], res["max_abs_err"] = rel_err(got[0], ref[0])
    res["rowsum_rel"] = rel_err(got[1], ref[1], row_abs_sums(x))[0]
    res["rowsumsq_rel"] = rel_err(got[2], ref[2])[0]
    exact = gram_f64(got[0])
    scale = float(exact.abs().max())
    for who, g in (("kernel", got[3]), ("plain", ref[3])):
        res[f"{who}_G_vs_f64_over_max"] = float((g.double() - exact).abs().max()) / scale
    res["G_vs_plain_over_max"] = float((got[3].double() - ref[3].double()).abs().max()) / scale
    log(f"    {json.dumps(res)}")
    if out_dtype == torch.bfloat16:
        check(within_bf16_ulp(got[0], ref[0]), f"{label} K2: bf16 Yc beyond one ulp")
    else:
        check(res["yc_rel"] <= 1e-5, f"{label} K2: yc_rel {res['yc_rel']:.3e} > 1e-5")
    for name in ("rowsum_rel", "rowsumsq_rel"):
        check(res[name] <= 1e-5, f"{label} K2: {name} {res[name]:.3e} > 1e-5")
    check(res["kernel_G_vs_f64_over_max"] <= 1e-5,
          f"{label} K2: G vs f64 {res['kernel_G_vs_f64_over_max']:.3e} max|G| > 1e-5")
    limit = 1e-5 + res["plain_G_vs_f64_over_max"]
    check(res["G_vs_plain_over_max"] <= limit,
          f"{label} K2: G vs plain {res['G_vs_plain_over_max']:.3e} > {limit:.3e}")
    yc = got[0]
    del got, ref, exact
    p1, k1, k2, p2 = event_ms(plain), event_ms(kernel), event_ms(kernel), event_ms(plain)
    m, t, n = res["m"], res["t"], res["n"]
    # X W (2 m t n) and Yc^T Yc counted whole (m n^2), at the peak of the
    # operands' type; X and W read, Yc, the (m, 2) stats and G written
    peak = PEAK_BF16 if x.dtype == torch.bfloat16 else PEAK_F32
    nbytes = (x.element_size() * (m * t + t * n) + yc.element_size() * m * n
              + 4 * (2 * m + n * n))
    res.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=None)
    res["bound_ms"], res["bound_by"] = bound(2 * m * t * n + m * n * n, peak, nbytes)
    log(f"    K2 {label}: ms {res['ms']:.3f} (plain {res['plain_ms']:.3f}, bound "
        f"{res['bound_ms']:.3f} by {res['bound_by']})")
    return res, yc


def compare_project(label: str, x: torch.Tensor, y: torch.Tensor) -> dict:
    """K3 against its plain version and the library on the card, on the
    same x and y (each f32 or bf16).  Tolerances: C within
    ``K3_F64_LIMIT`` max|C| of the f64 sums of Y^T X, and within 1e-5
    plus the plain version's own error of the plain version.  On f32
    operands a control, one TF32 pass (``torch.matmul(y.T, x)`` with TF32
    allowed, the flag restored), must miss that limit, so that it tells
    3xTF32 from one pass.  Library call: one ``torch.matmul(y.T, x)`` (f32
    with TF32 off), on bf16 operands ``torch.mm(y.T, x,
    out_dtype=torch.float32)``, the same function; the port never makes
    it.  Bound: on the tensor cores, 3xTF32 for f32 operands (three
    passes of 2MNT), two passes for bf16 x f32, one bf16 pass for bf16."""
    from dmd_era5_tpu_torch.ops.matmul import _project_plain, project, _project_row_shares

    def kernel():
        return project(x, y)

    def plain():
        return _project_plain(x, y)

    bf16 = (x.dtype == torch.bfloat16) + (y.dtype == torch.bfloat16)

    def library():
        return torch.mm(y.T, x, out_dtype=torch.float32) if bf16 == 2 else torch.matmul(y.T, x)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    exact = gram_f64(y, x)
    scale = float(exact.abs().max())
    (m, t), n = x.shape, y.shape[1]
    res = dict(label=label, m=m, t=t, n=n, dtypes=[str(a.dtype).replace("torch.", "") for a in (x, y)],
               row_shares=_project_row_shares(x, y))
    for who, c in (("kernel", got), ("plain", ref)):
        res[f"{who}_C_vs_f64_over_max"] = float((c.double() - exact).abs().max()) / scale
    if not bf16:
        saved = torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            one_pass = torch.matmul(y.T, x)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        res["one_tf32_pass_C_vs_f64_over_max"] = (
            float((one_pass.double() - exact).abs().max()) / scale)
        del one_pass
    diff = (got.double() - ref.double()).abs().max()
    res["max_abs_err"], res["C_vs_plain_over_max"] = float(diff), float(diff) / scale
    log(f"    {json.dumps(res)}")
    check(res["kernel_C_vs_f64_over_max"] <= K3_F64_LIMIT,
          f"{label} K3: C vs f64 {res['kernel_C_vs_f64_over_max']:.3e} max|C| > {K3_F64_LIMIT}")
    if not bf16:
        check(res["one_tf32_pass_C_vs_f64_over_max"] > K3_F64_LIMIT,
              f"{label} K3: one TF32 pass reads {res['one_tf32_pass_C_vs_f64_over_max']:.3e} "
              f"max|C|, within {K3_F64_LIMIT}: the limit does not tell 3xTF32 from it")
    limit = 1e-5 + res["plain_C_vs_f64_over_max"]
    check(res["C_vs_plain_over_max"] <= limit,
          f"{label} K3: C vs plain {res['C_vs_plain_over_max']:.3e} > {limit:.3e}")
    del got, ref, exact
    p1, k1, k2, p2 = event_ms(plain), event_ms(kernel), event_ms(kernel), event_ms(plain)
    res.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=event_ms(library))
    passes, peak = ((3, PEAK_TF32), (2, PEAK_TF32), (1, PEAK_BF16))[bf16]
    res["bound_ms"], res["bound_by"] = bound(
        passes * 2 * m * n * t, peak,
        x.element_size() * m * t + y.element_size() * m * n + 4 * n * t)
    log(f"    K3 {label}: ms {res['ms']:.3f} (plain {res['plain_ms']:.3f}, library "
        f"{res['library_ms']:.3f}, bound {res['bound_ms']:.3f} by {res['bound_by']}), "
        f"{res['row_shares']} row shares")
    return res


@contextlib.contextmanager
def stage_clock(module, *names: str):
    """Wall time of each call of ``module.<name>`` between two device
    synchronizations, into the yielded dict (name -> list of seconds)."""
    saved = {name: getattr(module, name) for name in names}
    times = {name: [] for name in names}

    def timed(name):
        def call(*args, **kwargs):
            out, secs = synced(saved[name], *args, **kwargs)
            times[name].append(secs)
            return out
        return call

    for name in names:
        setattr(module, name, timed(name))
    try:
        yield times
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def phase_wide_sketch(week: dict, seed: int) -> dict:
    """Phase 11: (a) K2 and K3 against their plain versions at the d = 3
    pass's shapes and types; then the randomized Hankel SVD at d = 3
    (N = 3 x 128 = 384, bf16 GEMMs, the function's default) on the
    ERA5-week X: past K1's N_MAX, so n_iter auto = 4 gives five two-pass
    passes (K2 5, K3 5, K1 0); then optDMD and the forecast at d = 3.
    Returns the main path's launch counts."""
    from dmd_era5_tpu_torch.ops import hankel_randomized_svd_fused, stacked_sketch_matrix

    d, k = 3, 100
    x = week["x"]
    t = x.shape[1]
    log("[11a] K2 and K3 against their plain versions at the d = 3 pass's shapes: bf16 X, "
        "stacked bf16 W (N = 384), bf16 Yc, no centring (CUDA-event ms)")
    torch.cuda.reset_peak_memory_stats()
    xb = x.to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    omega = torch.randn((t - d + 1, 128), generator=gen, device=x.device)
    w = stacked_sketch_matrix(omega, d, t).to(torch.bfloat16)
    _, yc = compare_sketch_center_gram("d3_pass", xb, w, center=False, out_dtype=torch.bfloat16)
    compare_project("d3_pass", xb, yc)
    del xb, w, yc
    log(f"    peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    times = {}
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    svd, times["hankel_svd_d3"] = synced(hankel_randomized_svd_fused, x, d, k, generator=gen)
    launches = launch_counts()
    u, s, v = svd
    orth = orthonormality(u)
    log(f"[11] d = 3 randomized Hankel SVD (bf16, N = 384): U {tuple(u.shape)}, max|U^T U - I| "
        f"{orth:.2e}, s[:8] {[round(float(a), 2) for a in s[:8]]}, launches {launches}")
    check(launches == counts(K2=5, K3=5), f"d = 3 Hankel SVD launched {launches}, expected K2 5, K3 5")
    # bf16 Yc: the whitening describes the stored values (tests/test_07:212's bound)
    check(orth <= 1e-2, f"d = 3 Hankel SVD: U^T U - I max {orth:.3e} > 1e-2")
    check(bool((s > 0).all()) and bool((s[1:] <= s[:-1]).all()), "d = 3: s not positive descending")
    dmd_and_forecast("d=3", svd, week, times, d)
    times["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"    stage wall times (s): {json.dumps(times)} (peak_gb: device memory over the phase's start)")
    del u, s, v, svd
    return launches


def year_config(**overrides) -> dict:
    """The port's parse of config.ini's [era5-svd], with the year's
    overrides (YEAR_CONFIG) and ``overrides``."""
    from dmd_era5_tpu_torch.core import config_parser, config_reader

    raw = config_reader("era5-svd", ROOT / "config.ini")
    return config_parser({**raw, **YEAR_CONFIG, **overrides}, "era5-svd")


def phase_year(seed: int) -> tuple[dict, dict]:
    """Phase 10 on one year of hourly 1-degree ERA5.  Returns the main
    path's launch counts and the K2 / K3 readings at the Hankel shape."""
    from dmd_era5_tpu_torch.ops import hankel, stacked_sketch_matrix
    from dmd_era5_tpu_torch.ops.matmul import _sketch_center_gram_project_cuda, _two_pass
    from dmd_era5_tpu_torch.pipeline import fit_step_fused, fit_step_lean, svd_on_era5
    from dmd_era5_tpu_torch.utils.labels import Field

    torch.cuda.reset_peak_memory_stats()
    times, total = {}, dict.fromkeys(KERNELS, 0)
    (x, truth, row_mean, alpha_true, noise_std), times["generate"] = synced(make_era5_year, seed)
    m, t = x.shape

    def centre():  # in place: a centred copy would be a second 34 GB
        mean = x.mean(dim=1)
        x.sub_(mean[:, None])
        return mean

    mean, times["center"] = synced(centre)
    year = dict(x=x, mean=mean, truth=truth, row_mean=row_mean, alpha_true=alpha_true)
    log(f"[10] ERA5 year X {tuple(x.shape)} f32 ({x.numel() * 4 / 1e9:.2f} GB) generated in "
        f"{times['generate']:.2f} s, centred in place in {times['center']:.2f} s; noise std "
        f"{noise_std:.4f}")

    def references():
        g64 = gram_f64(x)
        lam_x = torch.linalg.eigvalsh(g64).flip(0).clamp_min(0)
        lam_h = torch.linalg.eigvalsh(g64[:-1, :-1] + g64[1:, 1:]).flip(0).clamp_min(0)
        return g64, lam_x.cpu(), lam_h.cpu()

    # the exact SVDs of X and of its d = 2 Hankel embedding H, whose Gram
    # is g[:-1, :-1] + g[1:, 1:] for g = X^T X: f64 sums and f64 eigvalsh
    (g64, lam_x, lam_h), times["references"] = synced(references)
    s_x_ref, s_h_ref = lam_x.sqrt(), lam_h.sqrt()
    log(f"    exact references (f64 Gram and eigvalsh) in {times['references']:.2f} s: s(X)[:8] "
        f"{[round(float(a), 2) for a in s_x_ref[:8]]}, s(H)[99] / s(H)[0] "
        f"{float(s_h_ref[99] / s_h_ref[0]):.3e}")

    log("[10a] K2 and K3 against their plain versions at the path's shapes, K5 against the f64 "
        "Gram (CUDA-event ms)")
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    w_hankel = stacked_sketch_matrix(torch.randn((t - 1, 128), generator=gen, device=x.device), 2, t)
    k2_res, yc = compare_sketch_center_gram("hankel_pass", x, w_hankel, center=False)
    k3_res = compare_project("hankel_pass", x, yc)
    del yc
    w_fit = torch.randn((t, 128), generator=gen, device=x.device)
    _, yc = compare_sketch_center_gram("fit_step", x, w_fit, center=True)
    compare_project("fit_step", x, yc)
    del yc
    log("    K5 on X (K = 8,760) against the f64 Gram of the references; no plain version "
        "(its f32 H and L would be 68.5 GB beside X)")
    k5_res = compare_gram("year_X", x, "bf16_split", exact=g64, reps=1)
    del g64
    log(f"    K7 on the panel the streamed randomized route's first leaf gets from this year: "
        f"Z = X^T (X Omega), Omega ({t} x {R_SKETCH}) from the seed (Z's spectrum s^2); Q not "
        "held to the plain version's")
    omega = torch.randn((t, R_SKETCH), generator=gen, device=x.device)
    compare_householder("year Z", x.T @ (x @ omega), gate_q=False)
    del omega

    log("[10b] svd_on_era5 on config.ini's [era5-svd] defaults, year overrides "
        f"{json.dumps(YEAR_CONFIG)}")
    field = Field(x, ("space", "time"))
    parsed = year_config()
    check((parsed["svd_type"], parsed["delay_embedding"], parsed["precision"],
           parsed["svd_backend"]) == ("randomized", 2, "float32", "auto"),
          f"config.ini's [era5-svd] defaults moved: {parsed}")
    reset_counts()
    (u, s, v), times["svd_on_era5"] = synced(svd_on_era5, None, parsed, da_flat=field)
    launches = launch_counts()
    u, s, v = (torch.from_numpy(a).cuda() for a in (u, s, v))
    orth = orthonormality(u)
    log(f"    metrics {json.dumps(parsed['metrics'])}; U {tuple(u.shape)}, max|U^T U - I| "
        f"{orth:.2e}, s[:8] {[round(float(a), 2) for a in s[:8]]}, launches {launches}")
    check(parsed["metrics"]["svd_backend"] == "hankel", "the year did not resolve to hankel")
    check(launches == counts(K2=8, K3=8), f"svd_on_era5 launched {launches}, expected K2 8, K3 8")
    check(orth <= 1e-3, f"year Hankel SVD: U^T U - I max {orth:.3e} > 1e-3")
    check(bool((s > 0).all()) and bool((s[1:] <= s[:-1]).all()), "year: s not positive descending")
    inter = check_interlace("year (b) vs the exact Hankel SVD", s.cpu(), s_h_ref[:100])
    log(f"    (b) vs the f64 Hankel SVD: {json.dumps(inter)}")
    log("[10c] optDMD (rank 6) and a 24-step forecast on (b)")
    dmd_and_forecast("year", (u, s, v), year, times, d=2)
    s_rand = s.clone()
    total = {key: total[key] + n for key, n in launches.items()}
    del u, s, v

    log("[10d] svd_type = standard through svd_on_era5: the exact Hankel SVD")
    parsed = year_config(svd_type="standard")
    reset_counts()
    with stage_clock(hankel, "raw_gram") as gram_clock, stage_clock(torch.linalg, "eigh") as eigh_clock:
        (u, s, v), times["svd_on_era5_standard"] = synced(svd_on_era5, None, parsed, da_flat=field)
    launches = launch_counts()
    times["raw_gram_k5"], times["eigh"] = gram_clock["raw_gram"], eigh_clock["eigh"]
    s = torch.from_numpy(s)
    # the exact route's V_k comes from an f32 eigh of a bf16-split Gram,
    # which resolves the noise-floor directions only roughly: its s are
    # Rayleigh-Ritz values of that subspace, held below the f64 ones
    inter = check_interlace("year (d) vs the exact Hankel SVD", s, s_h_ref[:100])
    ratio_bd = s_rand.double().cpu() / s.double()
    log(f"    metrics {json.dumps(parsed['metrics'])}; raw Gram (K5) {times['raw_gram_k5']} s, "
        f"eigh {times['eigh']} s; s[:8] {[round(float(a), 2) for a in s[:8]]}, s[-1] "
        f"{float(s[-1]):.3f}; vs the f64 Hankel SVD: {json.dumps(inter)}; (b) / (d) from "
        f"{float(ratio_bd.min()):.6f} to {float(ratio_bd.max()):.6f}; launches {launches}")
    check(launches == counts(K2=1, K3=1, K5=1),
          f"year standard path launched {launches}, expected K5 1, K2 1, K3 1")
    total = {key: total[key] + n for key, n in launches.items()}
    del u, s, v

    log("[10e] fit_step_fused and fit_step_lean (f32, k = 100, sketch 128)")
    omega = torch.randn((t, 128), generator=gen, device=x.device)
    states = {}
    for name, step in (("fused", fit_step_fused), ("lean", fit_step_lean)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        states[name], times[f"fit_step_{name}"] = synced(step, x, omega, 100)
        launches = launch_counts()
        log(f"    {name}: {times[f'fit_step_{name}']:.3f} s, loss {float(states[name].loss):.6e}, "
            f"launches {launches}, device memory over its start "
            f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB")
        check(launches == counts(K2=1, K3=1), f"fit_step_{name} launched {launches}, expected K2 1, K3 1")
        total = {key: total[key] + n for key, n in launches.items()}
    fused, lean = states["fused"], states["lean"]
    s_fit = fused.s.double().cpu()

    def loss_of(energy):  # the loss of a fit that keeps this much of ||Xc||^2, in f64
        return math.sqrt(max(0.0, 1.0 - float(energy) / float(lam_x.sum())))

    u_rel = [float((fused.u[:, :c] - lean.u[:, :c]).norm() / fused.u[:, :c].norm()) for c in (6, 100)]
    agree = dict(s_rel=float(((fused.s - lean.s).abs() / fused.s).max()),
                 loss_fused=float(fused.loss), loss_lean=float(lean.loss),
                 loss_exact=loss_of(lam_x[:100].sum()), loss_rank6=loss_of(lam_x[:6].sum()),
                 # the fit's own s in f64, and the control: the same fit with
                 # its 94 components past the planted 6 dropped
                 loss_fit_s_f64=loss_of((s_fit * s_fit).sum()),
                 loss_control=loss_of((s_fit[:6] * s_fit[:6]).sum()),
                 tail_share=float((s_fit[6:] * s_fit[6:]).sum() / lam_x[6:100].sum()),
                 u_rel_lead6=u_rel[0], u_rel_all=u_rel[1])
    log(f"    fused vs lean, the exact loss and the control: {json.dumps(agree)}")
    inter = check_interlace("year fit step vs the exact SVD of X", s_fit, s_x_ref[:100])
    log(f"    fit step vs the f64 SVD of X: {json.dumps(inter)}")
    check(agree["s_rel"] <= 1e-5 and abs(agree["loss_lean"] / agree["loss_fused"] - 1) <= 1e-4,
          "fit_step_lean does not agree with fit_step_fused")
    check(u_rel[0] <= 1e-4, f"fit steps: leading-6 U differ by {u_rel[0]:.3e}")
    # the step's loss is sqrt(1 - ||Z||^2 / ||Xc||^2), and the planted 6
    # hold all but ~1e-4 of ||Xc||^2: the one-pass sketch's Ritz values,
    # ~5e-6 below the exact ones there, put it well above the exact loss,
    # which the f32 formula barely moves (loss_fit_s_f64).  It must not
    # fall below the optimum, and stays under FIT_LOSS_LIMIT, below the
    # control's reading; components 7-100 must hold their share of the
    # exact tail's energy
    loss_exact = agree["loss_exact"]
    check(loss_exact * (1 - 1e-3) <= agree["loss_fused"] <= loss_exact * FIT_LOSS_LIMIT,
          f"fit step loss {agree['loss_fused']:.6e} vs the exact rank-100 loss {loss_exact:.6e}")
    check(agree["loss_control"] > loss_exact * FIT_LOSS_LIMIT,
          f"the control's loss {agree['loss_control']:.6e} is within the fit's limit")
    check(agree["tail_share"] >= FIT_TAIL_SHARE_MIN,
          f"fit step: components 7-100 hold {agree['tail_share']:.4f} of the exact energy, "
          f"< {FIT_TAIL_SHARE_MIN}")
    del fused, lean, states

    log("[10f] K1 and the two-pass route on the same X and the Hankel pass's sketch (N = 256)")
    args = (torch.float32, False, False, False, None, True)

    def k1():
        return _sketch_center_gram_project_cuda(x, w_hankel, *args)

    def two_pass():
        return _two_pass(x, w_hankel, *args)

    a, b = k1(), two_pass()
    agree = {name: rel_err(p, q)[0] for name, p, q in (("G", a[3], b[3]), ("C", a[4], b[4]))}
    del a, b
    times_f = [event_ms(f, reps=2) for f in (two_pass, k1, k1, two_pass)]
    res_f = dict(k1_ms=(times_f[1] + times_f[2]) / 2, two_pass_ms=(times_f[0] + times_f[3]) / 2,
                 k1_vs_two_pass_rel=agree)
    n = w_hankel.shape[1]  # K1's bound as compare_kernel counts it (Yc and the row stats written)
    res_f["k1_bound_ms"], res_f["k1_bound_by"] = k1_bound(m, t, n, x.dtype, False)
    res_f["k1_stage_device_ms"] = k1_stage_ms(x, w_hankel, torch.float32, dict(center=False))
    K1_STAGES.append(dict(label="year_10f", m=m, t=t, n=n, dtype="float32",
                          **res_f["k1_stage_device_ms"]))
    log(f"    {json.dumps(res_f)}")
    check(max(agree.values()) <= 1e-5, f"K1 and the two-pass route disagree: {agree}")
    check(res_f["k1_ms"] < res_f["two_pass_ms"],
          f"K1 {res_f['k1_ms']:.1f} ms is not below the two passes' {res_f['two_pass_ms']:.1f} ms")
    times["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"    stage wall times (s): {json.dumps(times)}")
    del year, x, field
    return total, {"K2": k2_res, "K3": k3_res, "K5": k5_res}


def kernel_line(key: str, launches: int, res: dict) -> dict:
    name, source, replaces = KERNELS[key]
    max_abs = res["max_abs_err"]
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max_abs["yc"] if key == "K1" else max_abs,  # K1: y_wide of the SVD
                ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                bound_by=res["bound_by"], library_ms=res.get("library_ms"),
                **{key: res[key] for key in ("device_ms",) if key in res})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    smi = phase_device()
    sys.path.insert(0, str(ROOT))
    phase_build()

    phase_kernel_vs_plain(args.seed)
    reset_counts()  # the main path's first run starts here
    week = phase_slice(args.seed)
    x = week["x"]
    phase_fit_step(x, args.seed)
    launches = launch_counts()  # ... and ends here
    check(launches == counts(K1=7),
          f"main path launched {launches}, expected K1 5 + 2 and no other kernel")
    torch.cuda.reset_peak_memory_stats()
    hankel_cmp = phase_kernel_at_path_shapes(x, args.seed)
    gram_cmp = phase_gram_vs_plain(x, args.seed)
    for key, n in phase_standard(week).items():
        launches[key] += n
    truncated_launches, ref8 = phase_truncated(x, args.seed)
    for key, n in truncated_launches.items():
        launches[key] += n
    streamed_cmp = phase_streamed_kernels(x, args.seed)
    for key, n in phase_streamed(week, ref8, args.seed).items():
        launches[key] += n
    for key, n in phase_wide_sketch(week, args.seed).items():
        launches[key] += n
    # the week's tensors go before the year (34 GB) is built
    del week, x, ref8
    torch.cuda.empty_cache()
    year_launches, two_pass_cmp = phase_year(args.seed)
    for key, n in year_launches.items():
        launches[key] += n
    check(all(n > 0 for n in launches.values()), f"a kernel never ran on the main path: {launches}")
    for row in K1_STAGES:
        log(f"K1 stages, {row['label']} {row['dtype']} m {row['m']} t {row['t']} n {row['n']}: "
            f"device ms sketch {row['sketch']:.3f}, G {row['G']:.3f}, C {row['C']:.3f}")
    print(json.dumps({"kernels": [
        kernel_line("K1", launches["K1"], hankel_cmp),
        kernel_line("K2", launches["K2"], two_pass_cmp["K2"]),
        kernel_line("K3", launches["K3"], two_pass_cmp["K3"]),
        kernel_line("K4", launches["K4"], gram_cmp[("X", "highest")]),
        kernel_line("K5", launches["K5"], gram_cmp[("X", "bf16_split")]),
        kernel_line("K6", launches["K6"], streamed_cmp["f32"]),
        kernel_line("K7", launches["K7"], streamed_cmp[(T_HOURS, R_SKETCH)]),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
