"""Where K5's time goes on the card: device ms of variants of
``dmd_era5_tpu_torch/ops/csrc/gram.cu`` (its headers inlined) that drop
one phase of the bf16-split Gram each.

    python scripts/torch_k5_phases.py [--tree PATH] [--year-rows N]

``--tree`` reads the sources of another checkout of the repository (say a
parent commit unpacked with ``git archive``), so that one call can time
the kernel of two trees in turns; the variants are driven through this
tree's ``qr_panel.gram``, whose C entry (``gram_launch``) both share.
Each variant is the source with one edit, built by ``nvcc`` (the flags of
``ops/_build.py``) into ``build/k5_phases/<tree>/``:

    kernel      the source as it is
    no_mma      no MMA issued; its operands still loaded and split
                (G is wrong: timing only)
    no_split    the raw f32 bits taken as H and L, no bf16 rounding or
                subtraction (timing only)
    no_fold     no f64 sums: the f32 sums of a CTA's rows written at the
                end instead (timing only)
    no_staging  no copy of A into shared memory: the MMAs read what the
                slots hold (timing only)

The kernel that was retired (``atb_split_bf16``: mma.sync on a cp.async
ring) and the one that replaced it (``atb_split_wgmma``) each have their
own edits; the tree's source says which applies.  Shapes, f32 from a
seed: the ERA5 week's sketch Y (15,573,600 x 110) and X (x 168), 18c's
Y (1,048,576 x 110) and the hourly year's width (K 8,760) on a row cut
(``--year-rows``, 122,175 by default: an eighth of 977,400, so that
eight variants fit one call; the CTAs stream an eighth of the rows each,
the grid of 2,415 upper blocks is the year's).  Beside them:
``a.T @ a`` (f32, TF32 off) and ``a.sum()`` (A read once: the bytes
floor), and the kernel's max error against the f64 sums over max|G|;
then the kernel alone at the other shapes the smoke gives K5 (17b's Yc
and 18b's raw row block at P = 2, 7,786,800 x 128 and x 168, and phase
20's five CholQR2 leaves, 512-5,184 rows x 18-96), and the same calls
issued back to back by the host (``*_host_issued_ms``, CUDA events
without the sleep: what a caller of the small leaves waits).
Prints ptxas' registers and spill bytes of the kernel's instantiations,
one JSON line a shape, then the card's name and power limit.
Needs one CUDA card and nvcc (~45 GB of the card's memory at the week's
X).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms, event_ms, gram_f64  # noqa: E402
from dmd_era5_tpu_torch.ops import _build, _occupancy, qr_panel  # noqa: E402

HEADERS = ("gram_split_wgmma.cuh", "matmul_tc.cuh", "row_share_atb_tc.cuh")  # inlined in order
VARIANTS = ("kernel", "no_mma", "no_split", "no_fold", "no_staging")

# The retired mma.sync kernel (atb_split_bf16, row_share_atb_tc.cuh).
_OLD_FOLD = ("            sums[((mi * C::NI + ni) * 4 + q) * THREADS + tid] += (double)acc[mi][ni][q];\n"
             "            acc[mi][ni][q] = 0.f;\n")
OLD_EDITS = {
    "no_mma": [("  asm(\n      \"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                "  asm volatile(\"\" ::\"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), "
                "\"r\"(b[0]), \"r\"(b[1]));\n  if (0) asm(\n      "
                "\"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32")],
    "no_split": [("  hi = pack_bf16(v0, v1);\n  lo = pack_bf16(v0 - __uint_as_float(hi << 16), "
                  "v1 - __uint_as_float(hi & 0xffff0000u));",
                  "  hi = __float_as_uint(v0);\n  lo = __float_as_uint(v1);")],
    "no_fold": [(_OLD_FOLD, ""),
                ("dst[(size_t)r * nb + c] = sums[((mi * C::NI + ni) * 4 + q) * THREADS + tid];",
                 "dst[(size_t)r * nb + c] = acc[mi][ni][q];")],
    "no_staging": [("    if (s < n_slabs) stage(s);\n", ""),
                   ("    if (s + STAGES - 1 < n_slabs) stage(s + STAGES - 1);\n", "")],
}
# The wgmma kernel (atb_split_wgmma, gram_split_wgmma.cuh).
_NEW_SPLIT = """  atb_tc::split_bf16(v[0], v[1], h.x, l.x);
  atb_tc::split_bf16(v[2], v[3], h.y, l.y);
  atb_tc::split_bf16(v[4], v[5], h.z, l.z);
  atb_tc::split_bf16(v[6], v[7], h.w, l.w);"""
_NEW_RAW = """  h = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[2]), __float_as_uint(v[4]),
                 __float_as_uint(v[6]));
  l = make_uint4(__float_as_uint(v[1]), __float_as_uint(v[3]), __float_as_uint(v[5]),
                 __float_as_uint(v[7]));"""
NEW_EDITS = {
    "no_mma": [("    mma_step(d, ", "    if (0) mma_step(d, ")],
    "no_split": [(_NEW_SPLIT, _NEW_RAW)],
    "no_fold": [("    fold_group(in_tile);\n", "")],
    # TMA: the producer arrives with no copy; registers: no loads past the first two slabs
    "no_staging": [("          mm_tc::mbar_expect_tx(bar, slab_bytes());\n"
                    "          fetch(s, ring + slot * 2 * C::SLAB, bar);\n",
                    "          mm_tc::mbar_expect_tx(bar, 0);\n"),
                   ("      fetch(s + 2, vb[P], va[P]);\n", "")],
}


def source(tree: Path, name: str) -> str:
    """gram.cu of ``tree`` with its headers inlined and the variant's edits."""
    csrc = tree / "dmd_era5_tpu_torch" / "ops" / "csrc"
    src = (csrc / "gram.cu").read_text()
    for header in HEADERS:
        if (csrc / header).exists():
            src = src.replace(f'#include "{header}"', (csrc / header).read_text(), 1)
            src = src.replace(f'#include "{header}"', "")  # included again by a later header
    edits = (NEW_EDITS if "atb_split_wgmma(" in src else OLD_EDITS).get(name, [])
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: '{old.strip()[:70]}' is not in {tree}'s gram.cu")
        src = src.replace(old, new)
    return src


def build(tree: Path, out: Path, name: str) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(source(tree, name))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(so))


def ptxas(tree: Path, name: str) -> dict:
    """Registers and spill bytes ptxas gave each instantiation of the split
    kernel in a variant's build log."""
    lines = (ROOT / "build" / "k5_phases" / tree.name / f"{name}.log").read_text().splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "split" in line:
            kernel = line.split("'")[1]
            tail = " ".join(lines[i + 1:i + 6])
            regs = re.search(r"Used (\d+) registers", tail)
            spill = re.search(r"(\d+) bytes spill stores", tail)
            out[kernel] = [int(regs.group(1)) if regs else None, int(spill.group(1)) if spill else None]
    return out


def use(lib) -> None:
    """qr_panel.gram loads ``lib`` as its library from here on."""
    _build._LOADED["gram"] = lib
    qr_panel._LIB = None
    _occupancy._RESIDENT.clear()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(ROOT), help="checkout whose gram.cu is timed")
    parser.add_argument("--year-rows", type=int, default=977_400 // 8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    tree = Path(args.tree).resolve()
    out = ROOT / "build" / "k5_phases" / tree.name
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build(tree, out, n), VARIANTS)))
    print(json.dumps({"ptxas_registers_spill_bytes": ptxas(tree, "kernel")}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = (("week_Y", 721 * 1440 * 15, 110), ("week_X", 721 * 1440 * 15, 168),
              ("18c_Y", 1 << 20, 110), ("year_cut", args.year_rows, 8760))
    for label, m, k in shapes:
        a = torch.randn((m, k), generator=gen, device=dev)
        row = {"shape": label, "m": m, "k": k, "tree": str(tree.relative_to(ROOT))
               if tree.is_relative_to(ROOT) else str(tree)}
        reps = 3 if k > 1024 else 10
        for name, lib in libs.items():
            use(lib)
            if name == "kernel":
                exact = gram_f64(a)
                g = qr_panel.gram(a, "bf16_split")
                row["kernel_max_abs_vs_f64_over_max"] = float(
                    (g.double() - exact).abs().max() / exact.abs().max())
                row["symmetric"] = bool(torch.equal(g, g.T))
                del exact, g
            row[f"{name}_ms"] = device_ms(lambda: qr_panel.gram(a, "bf16_split"), reps=reps)
        row["library_ms"] = device_ms(lambda: a.T @ a, reps=reps)
        row["read_a_ms"] = device_ms(lambda: a.sum(), reps=reps)
        print(json.dumps(row), flush=True)
        del a
        torch.cuda.empty_cache()
    # the kernel alone where the smoke also gives K5: 17b's Yc and 18b's raw
    # row block at P = 2, phase 20's five CholQR2 leaves
    row = {"tree": str(tree.relative_to(ROOT)) if tree.is_relative_to(ROOT) else str(tree)}
    use(libs["kernel"])
    for m, k in ((7_786_800, 128), (7_786_800, 168), (4096, 96), (4096, 22), (1536, 18), (512, 64),
                 (5184, 24)):
        a = torch.randn((m, k), generator=gen, device=dev)
        row[f"{m}x{k}_ms"] = device_ms(lambda: qr_panel.gram(a, "bf16_split"), reps=20)
        row[f"{m}x{k}_host_issued_ms"] = event_ms(lambda: qr_panel.gram(a, "bf16_split"), reps=20)
        del a
    print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
