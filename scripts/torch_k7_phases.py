"""Where K7's time goes on the card, and how many CTAs it should take:
device ms of ``dmd_era5_tpu_torch/ops/csrc/householder.cu`` and of
variants that drop one phase each, at every CTA count that fits.

    python scripts/torch_k7_phases.py [--quick]

Each variant is the source with one edit, built by ``nvcc`` (the flags of
``ops/_build.py``) into ``build/k7_phases/``:

    kernel      the source as it is
    no_pass     no FMA of the reflectors' updates of the share nor of the
                next column's dot products (their loops, row j's write
                and the exchanges stay; Q and R wrong: timing only)
    no_q        no Q = I - W V_top^T after the last reflector (Q wrong:
                timing only)
    exchanges   neither of those, nor W = V T: what is left is the read of A,
                the n exchanges (sums over the row groups, tagged words
                out, the P partials polled in and summed), the scalars of
                each step and the last barrier -- the design's latency
                floor at that CTA count
    timed       the source with clock64 reads around each phase of a
                step (CTA 0's first thread; R wrong: timing only):
                cycles a step in each phase, the factorization's time and
                the SM clock it ran at

and launched through the library's own C entry (zeroed exchange words
each launch, as the wrapper does), Gaussian panels from a seed, at
``chip_smoke.py`` phase 9a's three K7 shapes (the week's 168 x 110
iterate and the envelope's edges 8,760 x 110 and 4,096 x 256) and
between them.  Times are ``chip_smoke.device_ms`` (the launches queued
behind a sleep of the card, so the host's time per call drops out),
beside the library's (``torch.linalg.qr`` with the diag(R) >= 0 flip)
and the CTA count that ``householder_shares`` picks.  Prints one JSON
line a shape, then the card's name and power limit.  ``--quick``: the three shapes only.  Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms  # noqa: E402
from dmd_era5_tpu_torch.ops import _build, qr_panel  # noqa: E402
from dmd_era5_tpu_torch.ops.tsqr import qr_positive  # noqa: E402

SRC = _build.CSRC_DIR / "householder.cu"
OUT = ROOT / "build" / "k7_phases"
PASS = [("        for (int u = 0; u < 4; ++u) x[k][u] = fmaf(-v, wc[u], x[k][u]);\n", ""),
        ("      for (int u = 0; u < 4; ++u) pc[u] = fmaf(vk, x[k][u], pc[u]);\n", "")]
NO_Q = [("    rows_times_tri<K>(W, ns, Vt, n, q, g, G, rows, acc);\n", "")]
NO_W = [("    if (j > 0) {\n      w_column(", "    if (false) {\n      w_column("),
        ("  w_column(W, ns, rows, r0, sm + L.vbuf + ((n - 1) & 1) * vstride, vdiag[n - 1], ybuf, "
         "beta_prev,\n           n - 1);\n", "")]
# clock64 cycles of CTA 0's thread 0 in each phase of the steps, summed over
# the steps, and the factorization's cycles and %globaltimer ns, into r[0:9]
TIMED = [
    ("  extern __shared__ __align__(16) float sm[];\n",
     "  extern __shared__ __align__(16) float sm[];\n"
     "  const long long k_c0 = clock64();\n  unsigned long long k_g0, k_g1;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(k_g0));\n'
     "  long long c_ph[7] = {0, 0, 0, 0, 0, 0, 0}, t_mark = 0;\n"),
    ("  for (int j = 0; j < n; ++j) {\n    // the exchange:",
     "  for (int j = 0; j < n; ++j) {\n    t_mark = clock64();\n    // the exchange:"),
    ("               beta_prev, j - 1);\n    }\n",
     "               beta_prev, j - 1);\n    }\n"
     "    c_ph[0] += clock64() - t_mark; t_mark = clock64();\n"),
    ("    // the reflector, the same in every thread of every CTA\n",
     "    c_ph[1] += clock64() - t_mark; t_mark = clock64();\n"
     "    // the reflector, the same in every thread of every CTA\n"),
    ("    const float sgn_j = alpha < 0.f ? -1.f : 1.f;\n",
     "    const float sgn_j = alpha < 0.f ? -1.f : 1.f;\n"
     "    c_ph[2] += clock64() - t_mark; t_mark = clock64();\n"),
    ("    if (tid == 0) {\n      vdiag[j] = vjj;",
     "    c_ph[3] += clock64() - t_mark; t_mark = clock64();\n"
     "    if (tid == 0) {\n      vdiag[j] = vjj;"),
    ("    // reflector j on the rows below j: the others",
     "    c_ph[4] += clock64() - t_mark; t_mark = clock64();\n"
     "    // reflector j on the rows below j: the others"),
    ("    if (j + 1 == n) break;\n",
     "    c_ph[5] += clock64() - t_mark; t_mark = clock64();\n    if (j + 1 == n) break;\n"),
    ("column j + 1's dots with every column below row j + 1\n  }\n",
     "column j + 1's dots with every column below row j + 1\n"
     "    c_ph[6] += clock64() - t_mark;\n  }\n"
     "  if (tid == 0 && p == 0) {\n"
     '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(k_g1));\n'
     "    for (int i = 0; i < 7; ++i) r[i] = (float)c_ph[i];\n"
     "    r[7] = (float)(clock64() - k_c0);\n    r[8] = (float)(k_g1 - k_g0);\n  }\n"),
]
TIMED_PHASES = ("sums_out_and_W", "partials_in", "reflector", "columns_R_V", "rest",
                "update", "next_column_and_dots")
VARIANTS = {"kernel": [], "no_pass": PASS, "no_q": NO_Q, "exchanges": [*PASS, *NO_Q, *NO_W],
            "timed": TIMED}
SHAPES = [(168, 110), (8760, 110), (4096, 256)]
MORE_SHAPES = [(512, 110), (1024, 110), (2048, 110), (4096, 110), (256, 256), (1024, 256)]
CTAS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 33, 44, 66, 88, 132)


def build(name: str) -> ctypes.CDLL:
    src = SRC.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"{name}: '{old.strip()}' is no longer in {SRC.name}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    so = ctypes.CDLL(str(lib))
    ptr, flag = ctypes.c_void_p, ctypes.c_int
    so.householder_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, flag, flag, flag, ptr]  # as the wrapper
    so.householder_launch.restype = flag
    return so


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    dev = torch.device("cuda")
    sms, smem = qr_panel._householder_limits(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, n in SHAPES + ([] if args.quick else MORE_SHAPES):
        a = torch.randn((m, n), generator=gen, device=dev)
        q = torch.empty((m, n), device=dev)
        r = torch.empty((n, n), device=dev)
        row = {"m": m, "n": n,
               "wrapper_ctas": len(qr_panel.householder_shares(m, n, sms, smem)),
               "library_device_ms": device_ms(lambda: qr_positive(a)), "by_ctas": {}}
        for ctas in CTAS:
            if ctas > min(sms, m) or -(-m // ctas) > qr_panel._householder_rows_cap(n, smem):
                continue
            v_top = torch.empty(qr_panel._tri_padded(n), device=dev)
            times = {}
            for name, lib in libs.items():
                def launch(lib=lib, name=name):
                    xg = torch.zeros(2 * (ctas + 1) * qr_panel._round4(n) + 1 if ctas > 1 else 0,
                                     dtype=torch.int64, device=dev)
                    rc = lib.householder_launch(a.data_ptr(), q.data_ptr(), r.data_ptr(),
                                                xg.data_ptr(), v_top.data_ptr(), m, n, ctas,
                                                torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise SystemExit(f"{name} at {ctas} CTAs: CUDA error {rc}")
                times[name] = device_ms(launch)
                if name == "timed":  # cycles a step by phase, the clock in GHz
                    got = r.flatten()[:9].tolist()
                    times["timed_cycles_a_step"] = {
                        ph: got[i] / n for i, ph in enumerate(TIMED_PHASES)}
                    times["timed_loop_us"] = got[8] / 1e3
                    times["timed_ghz"] = got[7] / got[8]
                if name == "kernel":
                    eye = torch.eye(n, device=dev, dtype=torch.float64)
                    times["orth"] = float((q.double().T @ q.double() - eye).abs().max())
            row["by_ctas"][ctas] = times
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)


if __name__ == "__main__":
    main()
