"""Where K3's time goes on the card: device ms of variants of
``dmd_era5_tpu_torch/ops/csrc/project.cu`` (its headers inlined) that drop
one phase of the projection C = Y^T X each.

    python scripts/torch_k3_phases.py [--tree PATH] [--year-rows N]

``--tree`` reads another checkout of the repository (say a parent commit's
package unpacked with ``git archive``): its package goes first on
``sys.path``, so each variant is driven through that tree's own
``ops.matmul.project`` and C entry, and one call can time the kernel of two
trees in turns.  Each variant is the source with one edit, built by
``nvcc`` (the flags of ``ops/_build.py``) into ``build/k3_phases/<tree>/``:

    kernel    the source as it is
    no_mma    no MMA: each wgmma instruction commented out of its asm,
              the operands still loaded and split (timing only)
    no_fold   no f64 fold every 128 rows: the f32 sums of a CTA's rows
              folded once, at the end (timing only; the retired mainloop
              writes its f32 sums instead)
    no_copy   no loads of X and Y after the first slabs: the slots are
              reused as they are (timing only)
    no_split  no split (3xTF32: hi/lo planes of the n-side operand) or
              restage (bf16) of the operand that the MMAs read from
              shared memory (timing only)

The retired mainloop (``atb_wgmma_*`` of ``row_share_atb_tc.cuh``, 128 x
128 blocks, loads staged through registers) and the kernel that replaced
it (``project_wgmma.cuh``) each have their own edits; the tree's sources
say which apply.  Shapes, Gaussian from a seed on the card, as
``chip_smoke.py`` gives K3 (M rows, X M x T, Y M x N): the d = 3 pass
(15,573,600 x 168 and x 384, bf16), 15c's U^T C (31,147,200 x 24 and x
100), 16e's ``hankel_project`` (1,038,240 x 97 and x 40), 18b's at P = 2
(7,786,800 x 168 and x 220) and the hourly year (8,760 hours, N 256) on a
row cut (``--year-rows``, 122,175 by default: an eighth of 977,400); all
f32 but the first.  Beside the variants: one library call of the same
function (``torch.matmul(y.T, x)`` with TF32 off; ``torch.mm(y.T, x,
out_dtype=torch.float32)`` on bf16) and ``x.sum() + y.sum()`` (X and Y
read once: the bytes floor), and the kernel's max error against the f64
sums over max|C|.  With the new kernel each row also names the block
that ``ops.matmul.project_block`` chose and times the table's other
block there: where that block keeps its f64 sums in shared memory, the
narrow side in more pieces with the sums in registers
(``registers_alt``); where it is the row-share mainloop (the year), the
block project_wgmma would take (``project_wgmma``; the variants' edits
reach only project_wgmma).  Prints ptxas' registers and
spill bytes of the kernel's instantiations, one JSON line a shape, then
the card's name and power limit.  Needs one CUDA card, nvcc and ~20 GB
of the card's memory (the d = 3 operands).
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

VARIANTS = ("kernel", "no_mma", "no_fold", "no_copy", "no_split")
OLD_HEADERS = ("row_share_atb_tc.cuh",)
NEW_HEADERS = ("project_wgmma.cuh", "gram_split_wgmma.cuh", "matmul_tc.cuh",
               "row_share_atb_tc.cuh")  # inlined in order

# no_mma: every warpgroup MMA instruction, and the fences, commits and waits
# around them, commented out of their asm (the MMAs' operands and outputs
# stay, so the fragments are still read and split)
_NO_MMA = [(f'"{op}', f'"// {op}') for op in (
    "wgmma.mma_async.sync.aligned.m64n", "wgmma.fence.sync.aligned;",
    "wgmma.commit_group.sync.aligned;", "wgmma.wait_group.sync.aligned %0;")]
# The retired mainloop (atb_wgmma_tf32x3 / atb_wgmma_bf16, row_share_atb_tc.cuh):
# each edit replaces every occurrence of its text.
_OLD_FOLD = "        sums[i * THREADS + tid] += (double)acc[i];\n        acc[i] = 0.f;\n"
OLD_EDITS = {
    "no_mma": _NO_MMA,
    "no_fold": [(_OLD_FOLD, ""),
                ("double v = sums[i * THREADS + tid];", "double v = acc[i];"),
                ("dst[(size_t)rr * nb + c] = sums[i * THREADS + tid];",
                 "dst[(size_t)rr * nb + c] = acc[i];")],
    "no_copy": [("    ldg_a(s + 2);\n    ldg_b(s + 3);\n", ""),
                ("    if (!diag) ldg(a, na, a0, s + 2, false, va);\n"
                 "    ldg(b, nb, b0, s + 2, true, vb);\n", "")],
    "no_split": [("    if (s + 1 < n_slabs) split_b(s + 1);  // beside the MMAs\n", ""),
                 ("    sts_b(s + 1, vb);\n", "")],
}
# The wgmma kernel (project_wgmma, project_wgmma.cuh): the lines it marks.
NEW_EDITS = {
    "no_mma": _NO_MMA,
    # (a fold group that never matches: removing the call crashes nvcc here)
    "no_fold": [("      if (decltype(qc)::value == q) fold(qc);", "      if (decltype(qc)::value == q + C::SPT) fold(qc);")],
    "no_copy": [("      produce(s - 1 + C::RING, (s - 1) % C::RING);  // the copies\n",
                 "      if (ctid == 0) k5::mbar_arrive(smem_u32(full + (s - 1) % C::RING));\n"),
                ("      produce(s + C::RING, s % C::RING);  // the copies\n",
                 "      if (ctid == 0) k5::mbar_arrive(smem_u32(full + s % C::RING));\n")],
    "no_split": [("      split_b(s + 1, std::integral_constant<int, 1 - P>{});  // the split\n",
                  "      wait_full(s + 1);\n")],
}


def is_new(tree: Path) -> bool:
    return (tree / "dmd_era5_tpu_torch" / "ops" / "csrc" / "project_wgmma.cuh").exists()


def source(tree: Path, name: str) -> str:
    """project.cu of ``tree`` with its headers inlined and the variant's edits."""
    csrc = tree / "dmd_era5_tpu_torch" / "ops" / "csrc"
    src = (csrc / "project.cu").read_text()
    new = is_new(tree)
    for header in NEW_HEADERS if new else OLD_HEADERS:
        src = src.replace(f'#include "{header}"', (csrc / header).read_text(), 1)
        src = src.replace(f'#include "{header}"', "")  # included again by a later header
    for old, repl in (NEW_EDITS if new else OLD_EDITS).get(name, []):
        if old not in src:
            raise SystemExit(f"{name}: '{old.strip()[:70]}' is not in {tree}'s project.cu")
        src = src.replace(old, repl)
    return src


def build(tree: Path, out: Path, nvcc: str, flags: list[str], name: str) -> ctypes.CDLL | None:
    """The variant's library, or None (its log printed) where nvcc fails:
    the other variants are still timed."""
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(source(tree, name))
    proc = subprocess.run([nvcc, *flags, "-o", str(so), str(cu)], capture_output=True, text=True)
    (out / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        print(json.dumps({"variant": name, "nvcc_exit": proc.returncode,
                          "stderr_tail": proc.stderr[-1500:]}), flush=True)
        return None
    return ctypes.CDLL(str(so))


def ptxas(log: Path) -> dict:
    """Registers and spill bytes ptxas gave each instantiation of the main
    kernel in a variant's build log."""
    lines = log.read_text().splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and ("atb_wgmma" in line or "project_wgmma" in line):
            kernel = line.split("'")[1]
            tail = " ".join(lines[i + 1:i + 6])
            regs = re.search(r"Used (\d+) registers", tail)
            spill = re.search(r"(\d+) bytes spill stores", tail)
            out[kernel] = [int(regs.group(1)) if regs else None, int(spill.group(1)) if spill else None]
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(ROOT), help="checkout whose project.cu is timed")
    parser.add_argument("--year-rows", type=int, default=977_400 // 8)
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(ROOT)]  # the tree's package; chip_smoke's helpers
    from chip_smoke import device_ms, gram_f64
    from dmd_era5_tpu_torch.ops import _build, _occupancy, matmul

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    label = str(tree.relative_to(ROOT)) if tree.is_relative_to(ROOT) else str(tree)
    out = ROOT / "build" / "k3_phases" / tree.name
    nvcc = _build._nvcc()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = pool.map(lambda n: build(tree, out, nvcc, _build.NVCC_FLAGS, n), VARIANTS)
        libs = {name: lib for name, lib in zip(VARIANTS, built) if lib is not None}
    if "kernel" not in libs:
        raise SystemExit("the kernel itself did not build")
    print(json.dumps({"tree": label, "ptxas_registers_spill_bytes": ptxas(out / "kernel.log")}),
          flush=True)

    def use(lib) -> None:
        _build._LOADED["project"] = lib
        matmul._PROJECT_LIB = None
        _occupancy._RESIDENT.clear()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = (  # label, M, T (X's columns), N (Y's columns), dtype
        ("d3", 15_573_600, 168, 384, torch.bfloat16),
        ("15c", 31_147_200, 24, 100, torch.float32),
        ("16e", 1_038_240, 97, 40, torch.float32),
        ("18b_P2", 7_786_800, 168, 220, torch.float32),
        ("year_cut", args.year_rows, 8760, 256, torch.float32),
    )
    for name, m, t, n, dtype in shapes:
        x = torch.randn((m, t), generator=gen, device=dev).to(dtype)
        y = torch.randn((m, n), generator=gen, device=dev).to(dtype)
        row = {"shape": name, "m": m, "t": t, "n": n, "dtype": str(dtype)[6:], "tree": label}
        if hasattr(matmul, "project_block"):
            row["block"] = matmul.project_block(m, n, t, y.dtype, x.dtype)._asdict()
        reps = 20 if m * (t + n) < 1 << 28 else 5
        for variant, lib in libs.items():
            use(lib)
            if variant == "kernel":
                exact = gram_f64(y, x)
                c = matmul.project(x, y)
                row["kernel_max_abs_vs_f64_over_max"] = float(
                    (c.double() - exact).abs().max() / exact.abs().max())
                row["row_shares"] = matmul._project_row_shares(x, y)
                del exact, c
            row[f"{variant}_ms"] = device_ms(lambda: matmul.project(x, y), reps=reps)
        use(libs["kernel"])
        rule = matmul.project_block(m, n, t, y.dtype, x.dtype) if "block" in row else None
        alts = {}
        if rule is not None and rule.mainloop == "row_share":
            # the block project_wgmma would take there, had the table not kept
            # the row-share mainloop
            wide = matmul._PROJECT_ROW_SHARE_WIDE
            matmul._PROJECT_ROW_SHARE_WIDE = max(n, t)
            alts["project_wgmma"] = matmul.project_block(m, n, t, y.dtype, x.dtype)
            matmul._PROJECT_ROW_SHARE_WIDE = wide
        if rule is not None and rule.sums == "shared" and rule.mainloop == "project_wgmma":
            # the table's other block there: the narrow side in more pieces of at
            # most _PROJECT_REG_N, the f64 sums in registers
            narrow = t if not rule.transposed else n
            pieces = -(-narrow // matmul._PROJECT_REG_N)
            bn = 8 * -(-(-(-narrow // pieces)) // 8)
            alts["registers_alt"] = rule._replace(n=bn, n_blocks=-(-narrow // bn), sums="registers")
        for name, alt in alts.items():
            row[f"{name}_block"] = alt._asdict()
            row[f"{name}_ms"] = device_ms(lambda: matmul._project_cuda(x, y, alt), reps=reps)
        if dtype == torch.bfloat16:
            row["library_ms"] = device_ms(lambda: torch.mm(y.T, x, out_dtype=torch.float32),
                                          reps=reps)
        else:
            row["library_ms"] = device_ms(lambda: torch.matmul(y.T, x), reps=reps)
        row["read_xy_ms"] = device_ms(lambda: x.sum() + y.sum(), reps=reps)
        print(json.dumps(row), flush=True)
        del x, y
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
