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
   another.

Phases 3-4, 7 and each call of 8 are the main path: every kernel's
launch count is set to 0 just before each and read just after, and
checked exactly.  The comparisons (2, 5, 6) are not counted.  The last
line is the JSON result; the line before it the card's name and power
limit; before that one JSON line with every kernel.  Without CUDA the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
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
    "K4": ("gram_highest", f"{CSRC}/gram.cu", "dmd_era5_tpu/ops/qr_panel.py:40"),
    "K5": ("gram_bf16_split", f"{CSRC}/gram.cu", "dmd_era5_tpu/ops/qr_panel.py:62"),
}
# H100 SXM published peaks (NVIDIA data sheet, dense): f32 on CUDA cores,
# bf16 on tensor cores, HBM3
PEAK_F32, PEAK_BF16, HBM_BYTES_S = 67e12, 989e12, 3.35e12

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
    t0 = time.perf_counter()
    # each loader runs its own nvcc at first use; threads start them together
    with ThreadPoolExecutor() as pool:
        for fut in [pool.submit(f) for f in (matmul._kernel_library, qr_panel._kernel_library)]:
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
            "K4": qr_panel.gram.launches["highest"],
            "K5": qr_panel.gram.launches["bf16_split"]}


def reset_counts() -> None:
    from dmd_era5_tpu_torch.ops import matmul, qr_panel

    matmul.sketch_center_gram_project.launches = 0
    qr_panel.gram.launches.update({p: 0 for p in qr_panel.gram.launches})


def bound(flops: float, peak: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate for their type and the bytes (each
    input read once, each output written once) over the HBM rate."""
    t_ops, t_mem = flops / peak, nbytes / HBM_BYTES_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def _chunks(a: torch.Tensor, rows: int = 1 << 19):
    """Row chunks of a (a 0-d tensor as one chunk of one)."""
    a = a.reshape(1) if a.ndim == 0 else a
    return [a[r:r + rows] for r in range(0, a.shape[0], rows)]


def rel_err(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor | None = None
            ) -> tuple[float, float]:
    """(relative Frobenius error, max abs error) of a against b, in f64,
    over row chunks: an (M, N) f64 copy at ERA5 size would be 32 GB.
    The error is relative to |scale| where given, else to |b|."""
    num = den = max_abs = 0.0
    ref = b if scale is None else scale
    for ac, bc, sc in zip(_chunks(a), _chunks(b), _chunks(ref)):
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
    slack where centring cancels), over row chunks."""
    top = float(b.abs().max())
    for ac, bc in zip(_chunks(a), _chunks(b)):
        bd = bc.double()
        ulp = torch.exp2(torch.floor(torch.log2(bd.abs().clamp_min(1e-30))) - 7)
        if not bool(((ac.double() - bd).abs() <= ulp + 2.0**-20 * top).all()):
            return False
    return True


def gram_f64(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """A^T B (B = A by default) in f64 over row chunks: the exact sums of
    the stored f32 matrices, against which the kernels are read."""
    b = a if b is None else b
    out = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float64, device=a.device)
    for ac, bc in zip(_chunks(a), _chunks(b)):
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
    held to the same 1e-5.  Times are CUDA-event ms; outputs are freed
    before timing, as at ERA5 size each Yc is up to 16 GB.
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
    n, size = w.shape[1], x.element_size()
    # X W (2 m n t), the symmetric half of Yc^T Yc (m n (n + 1)), Yc^T X
    # (2 m n t), counted as for K4 and K5; X and W read, Yc, the stats, G
    # and C written
    stats = 2 if flags.get("scalar_stats") else 2 * m
    bound_ms, bound_by = bound(
        m * n * (4 * t + n + 1), PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32,
        size * (m * t + t * n + m * n) + 4 * (stats + n * n + n * t))
    res = dict(label=label, m=m, t=t, n=n, dtype=str(dtype).replace("torch.", ""),
               flags=flags, centred=centred, rel_err=errs, **err_exact, max_abs_err=max_abs,
               ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound_ms, bound_by=bound_by)
    log(f"    {json.dumps(res)}")
    return res


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
    """X (S, 168) f32 on the card: per row the mock temperature recipe's
    mean, (265 - lapse) cos(latitude), plus three planted damped pairs
    with random complex patterns, plus noise at 1% of the signal's rms."""
    dev = torch.device("cuda")
    s_rows = N_BLOCKS * N_LAT * N_LON
    gen = torch.Generator(device=dev).manual_seed(seed)
    hours = torch.arange(T_HOURS, dtype=torch.float64, device=dev)
    alpha = torch.tensor([complex(d, 2 * math.pi / p) for d, p, _ in PAIRS],
                         dtype=torch.complex128, device=dev)
    amps = torch.tensor([a for *_, a in PAIRS], dtype=torch.float64, device=dev)

    def dynamics(h):
        return (amps[:, None] * torch.exp(alpha[:, None] * h[None, :])).to(torch.complex64)

    dyn = dynamics(hours)
    # Re(c e) with Re c, Im c ~ N(0, 1) has variance |e|^2
    signal_rms = float(torch.sqrt((dyn.abs() ** 2).sum(0).mean()))
    noise_std = NOISE_FRACTION * signal_rms
    x = torch.empty((s_rows, T_HOURS), dtype=torch.float32, device=dev)
    patterns = torch.empty((s_rows, len(PAIRS)), dtype=torch.complex64, device=dev)
    row_mean = torch.empty(s_rows, dtype=torch.float32, device=dev)
    levels = torch.tensor(LEVELS, dtype=torch.float32, device=dev)
    for r0 in range(0, s_rows, CHUNK):
        r1 = min(r0 + CHUNK, s_rows)
        rows = torch.arange(r0, r1, device=dev)
        lapse = (1000.0 - levels[(rows // (N_LAT * N_LON)) % len(LEVELS)]) / 100.0
        lat = 90.0 - 0.25 * ((rows // N_LON) % N_LAT).float()
        row_mean[r0:r1] = (265.0 - lapse) * torch.cos(torch.deg2rad(lat))
        c = torch.complex(
            torch.randn((r1 - r0, len(PAIRS)), generator=gen, device=dev),
            torch.randn((r1 - r0, len(PAIRS)), generator=gen, device=dev),
        )
        patterns[r0:r1] = c
        x[r0:r1] = (
            row_mean[r0:r1, None]
            + c.real @ dyn.real - c.imag @ dyn.imag
            + noise_std * torch.randn((r1 - r0, T_HOURS), generator=gen, device=dev)
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


def compare_gram(label: str, a: torch.Tensor, precision: str) -> dict:
    """K4 or K5 against its plain version and the f64 sums of A^T A.

    Tolerances: ``"highest"`` within 1e-6 relative Frobenius error of the
    f64 sums (K1 reads 2.5e-8 at this size), ``"bf16_split"`` within
    3e-5 max|G| of them (tests/test_25_linalg.py:102: the split drops
    L^T L and rounds L to bf16, ~1e-6 relative).  Against the plain
    version, whose f32 library sums over millions of rows are off by up
    to ~1e-5 themselves: within the kernel's own limit plus the plain
    version's error.  G must be exactly symmetric.  Times are CUDA-event
    ms in turns plain, kernel, kernel, plain; the library call is one f32
    ``a.T @ a`` (TF32 off), which the port never makes."""
    from dmd_era5_tpu_torch.ops.qr_panel import _gram_plain, gram

    def kernel():
        return gram(a, precision)

    def plain():
        return _gram_plain(a, precision)

    def library():
        return a.T @ a

    exact = gram_f64(a)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(torch.equal(got, got.T), f"{label} {precision}: G not exactly symmetric")
    scale = float(exact.abs().max())
    res = dict(label=label, precision=precision, m=a.shape[0], k=a.shape[1])
    for who, g in (("kernel", got), ("plain", ref)):
        res[f"{who}_rel_vs_f64"] = rel_err(g, exact)[0]
        res[f"{who}_max_abs_vs_f64_over_max"] = float((g.double() - exact).abs().max()) / scale
    res["rel_vs_plain"], res["max_abs_err"] = rel_err(got, ref)
    if precision == "highest":
        limit = 1e-6
        check(res["kernel_rel_vs_f64"] <= limit,
              f"{label} K4: G relative error vs f64 {res['kernel_rel_vs_f64']:.3e} > {limit}")
        limit_plain = limit + res["plain_rel_vs_f64"]
        got_plain = res["rel_vs_plain"]
    else:
        limit = 3e-5
        check(res["kernel_max_abs_vs_f64_over_max"] <= limit,
              f"{label} K5: G max error vs f64 {res['kernel_max_abs_vs_f64_over_max']:.3e} "
              f"max|G| > {limit}")
        limit_plain = limit + res["plain_max_abs_vs_f64_over_max"]
        got_plain = res["max_abs_err"] / scale
    check(got_plain <= limit_plain,
          f"{label} {precision}: kernel vs plain {got_plain:.3e} > {limit_plain:.3e}")
    del got, ref, exact
    p1, k1, k2, p2 = event_ms(plain), event_ms(kernel), event_ms(kernel), event_ms(plain)
    res.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=event_ms(library))
    m, k = a.shape
    if precision == "highest":  # the symmetric half in full f32 on CUDA cores
        res["bound_ms"], res["bound_by"] = bound(m * k * (k + 1), PEAK_F32, 4 * m * k + 4 * k * k)
    else:  # H^T H (symmetric half) and H^T L, both bf16 products
        res["bound_ms"], res["bound_by"] = bound(
            m * k * (k + 1) + 2 * m * k * k, PEAK_BF16, 4 * m * k + 4 * k * k)
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
    check(launches == {"K1": 1, "K4": 0, "K5": 1},
          f"standard path launches {launches}, expected K1 1, K4 0, K5 1")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"    stage wall times (s): {json.dumps({a: round(b, 3) for a, b in times.items()})}; "
        f"launches {launches}; peak device memory {peak:.2f} GB")
    del u, s, v, svd
    return launches


def phase_truncated(x: torch.Tensor, seed: int) -> dict:
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
    the run; its readings are logged above the checks."""
    from dmd_era5_tpu_torch.ops import truncated_svd

    k = 100
    routes = [
        ("a gram bf16_split", dict(svd_type="standard"), {"K1": 1, "K4": 0, "K5": 1}),
        ("b gram highest", dict(svd_type="standard", gram_precision="highest"),
         {"K1": 1, "K4": 1, "K5": 0}),
        ("c tsqr", dict(svd_type="standard", exact_method="tsqr"), {"K1": 0, "K4": 0, "K5": 2}),
        ("d randomized", dict(svd_type="randomized", seed=seed + 5), {"K1": 0, "K4": 0, "K5": 10}),
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
    return total


def kernel_line(key: str, launches: int, res: dict) -> dict:
    name, source, replaces = KERNELS[key]
    max_abs = res["max_abs_err"]
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max_abs["yc"] if key == "K1" else max_abs,  # K1: y_wide of the SVD
                ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                bound_by=res["bound_by"], library_ms=res.get("library_ms"))


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
    check(launches == {"K1": 7, "K4": 0, "K5": 0},
          f"main path launched {launches}, expected K1 5 + 2 and no Gram kernel")
    torch.cuda.reset_peak_memory_stats()
    hankel_cmp = phase_kernel_at_path_shapes(x, args.seed)
    gram_cmp = phase_gram_vs_plain(x, args.seed)
    for key, n in phase_standard(week).items():
        launches[key] += n
    for key, n in phase_truncated(x, args.seed).items():
        launches[key] += n
    check(all(n > 0 for n in launches.values()), f"a kernel never ran on the main path: {launches}")
    print(json.dumps({"kernels": [
        kernel_line("K1", launches["K1"], hankel_cmp),
        kernel_line("K4", launches["K4"], gram_cmp[("X", "highest")]),
        kernel_line("K5", launches["K5"], gram_cmp[("X", "bf16_split")]),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
