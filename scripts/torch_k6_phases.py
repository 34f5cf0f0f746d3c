"""Where K6's time goes on the card: CUDA-event ms of variants of
``dmd_era5_tpu_torch/ops/csrc/matmul.cu`` (with its mainloop,
``matmul_tc.cuh``, inlined) that drop one phase each, and
what restarting the MMA sums every chunk buys in accuracy.

    python scripts/torch_k6_phases.py

Each variant is the source with one edit, built by ``nvcc`` (the flags of
``ops/_build.py``) into ``build/k6_phases/``:

    kernel      the source as it is
    no_mma      no warpgroup MMA issued (out is wrong: timing only)
    no_store    no store of out (out is left unwritten: timing only)
    no_mma_no_store
    sleep_NS    each chunk's MMAs replaced by a sleep of NS ns
    ring_2      a ring of 2 x chunks instead of 4
    chained     every MMA of a row tile chained, not restarted from zero
                each chunk (out is the product: timing and accuracy)

and launched through the library's own C entry on the shapes of
``chip_smoke.py`` phase 9a: the streamed block (65,536 x 168 @ 168 x 110)
in f32 and with bf16 operands, and the ragged tail (41,568 rows, f32),
Gaussian from a seed.  Each time is of back-to-back launches (CUDA
events); ``kernel_device`` is the kernel's device time alone
(``chip_smoke.device_ms``: launches queued behind a sleep of the card).
Yardsticks in the same run: ``out.fill_`` (the bytes of out written
once), ``copy_`` of x (x read and written once), ``torch.mm`` and an
empty kernel launched through ctypes as K6 is (``empty_launch``).  If the
phases overlapped, dropping one would cost nothing until it is the
longest; if they add up, each drop saves its own time.  Accuracy:
``kernel``'s, ``chained``'s and the plain f32 product's max error against
the f64 product over max|out| (``*_vs_f64``).  Prints one JSON line a
shape, then the card's name and power limit.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms, event_ms  # noqa: E402
from dmd_era5_tpu_torch.ops import _build  # noqa: E402

SRC = _build.CSRC_DIR / "matmul.cu"
MAINLOOP = _build.CSRC_DIR / "matmul_tc.cuh"  # inlined into SRC, where the edits land
OUT = ROOT / "build" / "k6_phases"
MMA = ("wgmma_tf32(d,", "wgmma_bf16(d,")
STORES = ("static_cast<bf16*>(out)[o] = ", "static_cast<float*>(out)[o] = ")
WAIT = "      atb_tc::wgmma_wait<0>();\n"
EMPTY = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def variant(name: str) -> str:
    """The source with the edit that names the variant."""
    if name == "empty":
        return EMPTY
    src = SRC.read_text().replace(f'#include "{MAINLOOP.name}"', MAINLOOP.read_text())
    edits: list[tuple[str, str]] = []
    if "no_mma" in name or name.startswith("sleep_"):
        edits += [(m, f"if (0) {m}") for m in MMA]
    if "no_store" in name:
        edits += [(st, f"if (0) {st}") for st in STORES]
    if name.startswith("sleep_"):
        edits.append((WAIT, f"{WAIT}      __nanosleep({int(name[6:])});\n"))
    if name == "ring_2":  # the freed 32 KB leave w's planes as they are
        edits += [("static constexpr int STAGES = BN == 112 ? 4 : 2;",
                   "static constexpr int STAGES = 2;"),
                  ("kmax<float, 112>() == 168 && kmax<bf16, 112>() == 672 && ", "")]
    if name == "chained":  # d starts from zero at a tile's first chunk only
        edits += [("q == 0 ? 0 : 1", "ci == 0 && q == 0 ? 0 : 1"),
                  ("for (int i = 0; i < NACC; ++i) acc[i] += d[i];",
                   "for (int i = 0; i < NACC; ++i) acc[i] = d[i];")]
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: '{old.strip()}' is no longer in {SRC.name} or {MAINLOOP.name}")
        src = src.replace(old, new)
    return src


def build(name: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(variant(name))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    so = ctypes.CDLL(str(lib))
    ptr, flag = ctypes.c_void_p, ctypes.c_int
    if name == "empty":
        so.empty_launch.argtypes, so.empty_launch.restype = [ptr], flag
    else:
        so.matmul_launch.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, flag, flag, flag, flag,
                                     flag, ptr]
        so.matmul_launch.restype = flag
    return so


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["kernel", "no_mma", "no_store", "no_mma_no_store", "sleep_300", "sleep_600", "ring_2",
             "chained", "empty"]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    empty = libs.pop("empty")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x_all = torch.randn((65_536 + 41_568, 168), generator=gen, device=dev)
    w = torch.linalg.qr(torch.randn((168, 110), generator=gen, device=dev))[0].contiguous()
    ctas = torch.cuda.get_device_properties(dev).multi_processor_count  # one CTA an SM
    shapes = {"block_f32": (x_all[:65_536], w),
              "block_bf16": (x_all[:65_536].bfloat16(), w.bfloat16()),
              "tail_f32": (x_all[65_536:], w)}
    for label, (x, wt) in shapes.items():
        (m, k), n = x.shape, wt.shape[1]
        out = torch.empty((m, n), device=dev)
        bf16 = int(x.dtype == torch.bfloat16)
        row = {"shape": label}
        ref = x.float() @ wt.float()
        exact = x.double() @ wt.double()
        scale = float(exact.abs().max())
        row["plain_vs_f64"] = float((ref.double() - exact).abs().max()) / scale
        for name, lib in libs.items():
            def launch(lib=lib, name=name):
                rc = lib.matmul_launch(x.data_ptr(), wt.data_ptr(), out.data_ptr(), m, k, n, bf16,
                                       0, ctas, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"{name}: CUDA error {rc}")
            row[name] = event_ms(launch, reps=20)
            if name in ("kernel", "chained"):
                row[f"{name}_rel_err"] = float((out - ref).norm() / ref.norm())
                row[f"{name}_vs_f64"] = float((out.double() - exact).abs().max()) / scale
            if name == "kernel":
                row["kernel_device"] = device_ms(launch)
        copy = torch.empty_like(x)
        row["fill_out"] = event_ms(lambda: out.fill_(1.0), reps=20)
        row["copy_x"] = event_ms(lambda: copy.copy_(x), reps=20)
        mm = (lambda: torch.mm(x, wt, out_dtype=torch.float32)) if bf16 else (lambda: torch.mm(x, wt))
        row["torch_mm"] = event_ms(mm, reps=20)
        row["torch_mm_device"] = device_ms(mm)
        stream = torch.cuda.current_stream().cuda_stream
        row["empty_launch"] = event_ms(lambda: empty.empty_launch(stream), reps=200)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)


if __name__ == "__main__":
    main()
