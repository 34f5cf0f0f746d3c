"""Where the time of K4 (``gram(a, "highest")``) and of K1's G stage (and
C stage, in a tree that runs it on the same mainloop) goes on the card:
device ms of variants of their kernel source that each drop one phase.

    python scripts/torch_k4_phases.py [--tree PATH] [--only LABEL,LABEL]

``--tree`` reads another checkout of the repository (say a parent commit's
package unpacked with ``git archive``): its package goes first on
``sys.path``, so each variant is driven through that tree's own
``ops.qr_panel.gram`` and ``ops.matmul._scgp_plan``, and one call can time
the kernels of two trees in turns.  Each variant is the tree's
``ops/csrc`` with one edit (every file that holds the edited text), built
by ``nvcc`` (the flags of ``ops/_build.py``) into
``build/k4_phases/<tree>/<variant>/``: the tree's row-share A^T B library,
``atb.cu`` where the tree has it (this mainloop, ``atb_wgmma.cuh``), else
``gram.cu`` and ``sketch_center_gram_project.cu`` (the retired
``atb_wgmma_*`` kernels of ``row_share_atb_tc.cuh``).

    kernel     the source as it is
    no_mma     no MMA: each wgmma instruction, fence, commit and wait
               commented out of its asm (timing only)
    no_fold    no f64 fold every 128 rows: the f32 sums folded once, at
               the end (timing only)
    no_copy    no copies of A and B after the ring's first slabs: the
               slots are reused as they are (timing only)
    no_split   no split of B into tf32 planes (f32) and no restage
               (timing only)
    no_reduce  no reduction launch over the row shares (timing only)

Shapes, Gaussian from a seed on the card, as ``chip_smoke.py`` gives them:
K4 at the week's X (15,573,600 x 168), sketch Y (x 110) and fit-step Yc
(x 128), 14c's mrDMD window (31,147,200 x 82) and 15a's Y block (65,536 x
128), f32; K1's G and
C stages at the week's Hankel pass (N 256, f32), the week's bf16 fit step
(N 128) and the bench shape (2^19 x 512, N 128, f32), and K2's G stage at
the d = 3 pass (N 384, bf16), each stage through the wrapper's plan
(``run(mask)``).  The C stage only in a tree without ``atb.cu`` (it ran
on the row-share mainloop there); with ``atb.cu`` it is K3's kernel,
whose phases ``scripts/torch_k3_phases.py`` gives.  Beside the variants: one library call of the same
function (``a.T @ a``, ``yc.T @ yc``, ``yc.T @ x``; bf16 with
``out_dtype=torch.float32``) and the operands read once (``a.sum()``; the
bytes floor).  Prints ptxas' registers and spill bytes of the kernel's
instantiations, one JSON line a shape, then the card's name and power
limit.  Needs one CUDA card, nvcc and ~30 GB of the card's memory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

VARIANTS = ("kernel", "no_mma", "no_fold", "no_copy", "no_split", "no_reduce")
_NO_MMA = [(f'"{op}', f'"// {op}') for op in (
    "wgmma.mma_async.sync.aligned.m64n", "wgmma.fence.sync.aligned;",
    "wgmma.commit_group.sync.aligned;", "wgmma.wait_group.sync.aligned %0;")]
# this mainloop (atb_wgmma.cuh): each edit replaces every occurrence of its text
NEW_EDITS = {
    "no_mma": _NO_MMA,
    # (a fold group that never matches: removing the call crashes nvcc)
    "no_fold": [("      if (decltype(qc)::value == q) fold(qc);",
                 "      if (decltype(qc)::value == q + C::SPT) fold(qc);")],
    "no_copy": [("produce(s + C::RING, s % C::RING);  // the copies",
                 "{ if (ctid == 0) k5::mbar_arrive(smem_u32(full + s % C::RING)); }"),
                ("issue_copies(s - 1 + C::RING, (s - 1) % C::RING, false, false);  // the copies, beside the MMAs",
                 "k5::mbar_arrive(smem_u32(full + (s - 1) % C::RING));"),
                ("    if (early_elem) produce(s - 1 + C::RING, (s - 1) % C::RING);",
                 "    if (early_elem && ctid == 0) k5::mbar_arrive(smem_u32(full + (s - 1) % C::RING));")],
    "no_split": [("    if (s + 1 < n_slabs) split(s + 1);  // the split",
                  "    if (s + 1 < n_slabs) wait_full(s + 1);")],
    "no_reduce": [("  if (err != cudaSuccess || p.part == nullptr) return err;", "  return err;")],
}
# the retired mainloop (atb_wgmma_tf32x3 / atb_wgmma_bf16, row_share_atb_tc.cuh)
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
    "no_reduce": [("  atb_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, out, n_share, na,",
                   "  if (false) atb_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, out, "
                   "n_share, na,")],
}


def is_new(tree: Path) -> bool:
    return (tree / "dmd_era5_tpu_torch" / "ops" / "csrc" / "atb.cu").exists()


def sources(tree: Path) -> tuple[str, ...]:
    """The libraries that carry K4 and K1's G stage (and C stage) in ``tree``."""
    return ("atb",) if is_new(tree) else ("gram", "sketch_center_gram_project")


def build(tree: Path, out: Path, nvcc: str, flags: list[str], name: str) -> dict | None:
    """The variant's libraries by name, or None (the log printed) where nvcc
    fails: the other variants are still timed."""
    d = out / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(tree / "dmd_era5_tpu_torch" / "ops" / "csrc", d)
    for old, repl in (NEW_EDITS if is_new(tree) else OLD_EDITS).get(name, []):
        hits = [f for f in d.iterdir() if old in f.read_text()]
        if not hits:
            raise SystemExit(f"{name}: '{old.strip()[:70]}' is not in {tree}'s csrc")
        for f in hits:
            f.write_text(f.read_text().replace(old, repl))
    libs = {}
    for src in sources(tree):
        so = d / f"lib{src}.so"
        proc = subprocess.run([nvcc, *flags, "-o", str(so), str(d / f"{src}.cu")],
                              capture_output=True, text=True)
        (d / f"{src}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode:
            print(json.dumps({"variant": name, "source": src, "nvcc_exit": proc.returncode,
                              "stderr_tail": proc.stderr[-1500:]}), flush=True)
            return None
        libs[src] = ctypes.CDLL(str(so))
    return libs


def ptxas(log: Path) -> dict:
    """Registers and spill bytes ptxas gave each instantiation of the main
    kernel in a variant's build log, and the count of its waits injected
    around MMAs (C7517) and serialized MMAs (C7513)."""
    lines = log.read_text().splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "atb_wgmma" in line:
            kernel = line.split("'")[1]
            tail = " ".join(lines[i + 1:i + 6])
            regs = re.search(r"Used (\d+) registers", tail)
            spill = re.search(r"(\d+) bytes spill stores", tail)
            out[kernel] = [int(regs.group(1)) if regs else None, int(spill.group(1)) if spill else None]
    out["C7517"] = sum("C7517" in line for line in lines)
    out["C7513"] = sum("C7513" in line for line in lines)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(ROOT), help="checkout whose kernels are timed")
    parser.add_argument("--only", default="", help="comma-separated shape labels (default: all)")
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(ROOT)]  # the tree's package; chip_smoke's helpers
    from chip_smoke import device_ms
    from dmd_era5_tpu_torch.ops import _build, _occupancy, matmul, qr_panel

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    label = str(tree.relative_to(ROOT)) if tree.is_relative_to(ROOT) else str(tree)
    out = ROOT / "build" / "k4_phases" / tree.name
    nvcc = _build._nvcc()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = pool.map(lambda n: build(tree, out, nvcc, _build.NVCC_FLAGS, n), VARIANTS)
        libs = {name: lib for name, lib in zip(VARIANTS, built) if lib is not None}
    if "kernel" not in libs:
        raise SystemExit("the kernel itself did not build")
    print(json.dumps({"tree": label, "ptxas_registers_spill_bytes": {
        src: ptxas(out / "kernel" / f"{src}.log") for src in sources(tree)}}), flush=True)

    def use(variant: str) -> None:
        for src, lib in libs[variant].items():
            _build._LOADED[src] = lib
        matmul._LIB = qr_panel._LIB = None
        if is_new(tree):
            from dmd_era5_tpu_torch.ops import atb

            atb._LIB = None
        _occupancy._RESIDENT.clear()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    week = 721 * 1440 * 15
    f32, bf16 = torch.float32, torch.bfloat16
    only = set(args.only.split(",")) - {""}
    grams = (("K4_week_X", week, 168), ("K4_week_Y", week, 110), ("K4_14c_window", 2 * week, 82),
             ("K4_week_Yc_128", week, 128), ("K4_15a_Y_block", 65_536, 128))
    for name, m, k in grams:
        if only and name not in only:
            continue
        a = torch.randn((m, k), generator=gen, device=dev)
        row = {"shape": name, "m": m, "k": k, "tree": label}
        reps = 20 if m < 1 << 20 else 5
        for variant in libs:
            use(variant)
            row[f"{variant}_ms"] = device_ms(lambda: qr_panel.gram(a), reps)
        use("kernel")
        row["library_ms"] = device_ms(lambda: a.T @ a, reps)
        row["read_a_ms"] = device_ms(lambda: a.sum(), reps)
        print(json.dumps(row), flush=True)
        del a
        torch.cuda.empty_cache()
    stages = (("K1_hankel_week_N256", week, 168, 256, f32, dict(center=False), 7),
              ("K1_fit_week_bf16", week, 168, 128, bf16, dict(center=True, scalar_stats=True), 7),
              ("K1_bench_f32", 1 << 19, 512, 128, f32, dict(center=True, scalar_stats=True), 7),
              ("K2_d3_N384_bf16", week, 168, 384, bf16, dict(center=True), 3))
    for name, m, t, n, dtype, flags, mask in stages:
        if only and name not in only:
            continue
        x = torch.randn((m, t), generator=gen, device=dev).to(dtype)
        w = torch.randn((t, n), generator=gen, device=dev).to(dtype)
        use("kernel")
        args_ = {key: flags.get(key, default) for key, default in (
            ("center", True), ("stats_col", False), ("scalar_stats", False), ("t_valid", None),
            ("emit_yc", True))}
        res, run = matmul._scgp_plan(x, w, dtype, **args_, stages=mask)
        run(mask)
        yc = res["yc"]
        reps = 20 if m < 1 << 20 else 5
        mm = (lambda p, q: torch.mm(p, q, out_dtype=torch.float32)) if dtype == bf16 else torch.mm
        for stage, bit in (("G", 2), ("C", 4)):
            if not mask & bit or (bit == 4 and is_new(tree)):
                continue
            row = {"shape": f"{name}_{stage}", "m": m, "t": t, "n": n, "dtype": str(dtype)[6:],
                   "tree": label}
            for variant in libs:
                use(variant)
                row[f"{variant}_ms"] = device_ms(lambda: run(bit), reps)
            use("kernel")
            row["library_ms"] = device_ms((lambda: mm(yc.T, yc)) if bit == 2 else (lambda: mm(yc.T, x)),
                                          reps)
            row["read_operands_ms"] = device_ms(
                (lambda: yc.sum()) if bit == 2 else (lambda: yc.sum() + x.sum()), reps)
            print(json.dumps(row), flush=True)
        del x, w, res, run, yc
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
