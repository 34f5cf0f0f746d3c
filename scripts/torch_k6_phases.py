"""Where the streamed block product's time goes on the card: device ms of
variants of K6 (``dmd_era5_tpu_torch/ops/csrc/matmul.cu``) and of K1's
sketch stage (``sketch_center_gram_project.cu``, stage 1), each with its
mainloop ``matmul_tc.cuh`` inlined, that drop one phase each; and what
restarting the MMA sums every chunk buys in accuracy.

    python scripts/torch_k6_phases.py [--tree PATH] [--year-rows N] [--only K6|sketch]

``--tree`` reads another checkout of the repository (say a parent
commit's package unpacked with ``git archive``): its package goes first
on ``sys.path``, so each variant is driven through that tree's own
``ops.matmul`` wrappers and C entries, and one call can time two trees
in turns.  Each variant is the source with one edit, built by ``nvcc``
(the flags of ``ops/_build.py``) into ``build/k6_phases/<tree>/``:

    kernel    the source as it is
    no_mma    no warpgroup MMA issued (out is wrong: timing only)
    no_store  no store of out (out is left unwritten: timing only)
    no_copy   no copy of x into the ring: the slots are used as they are
              (timing only)
    no_stats  K1's sketch without its row sums and sums of squares
              (timing only)
    chained   K6 with every MMA of a row tile chained, not restarted from
              zero each chunk (out is the product: timing and accuracy)

and, where the shared memory holds more ring slots than the rule gives, the
same block with as many as it holds, up to 8 (``ring_8_ms``).

Shapes, Gaussian from a seed on the card.  K6 (M x K @ K x N): 16e's
``hankel_sketch`` (1,038,240 x 97 @ 97 x 40), 16d's streamed block
(65,536 x 97 @ 97 x 20), 15c's U L (31,147,200 x 100 @ 100 x 24), the
week's streamed block (65,536 x 168 @ 168 x 110, f32 and bf16), 15a's
block (65,536 x 168 @ 168 x 128) and a lift chunk of 15c (2,097,152 x 124
@ 124 x 100), f32 but where named.  K1's sketch stage (M x T, N):
the bench's shape (2^19 x 512, N 128, bf16 and f32, centred, scalar
statistics), config 2's Hankel pass (1,038,240 x 97, N 76, f32, not
centred), the week's fit step (15,573,600 x 168, N 128, bf16, centred,
scalar statistics) and its Hankel pass (N 256, f32, not centred), the
hourly year's W streamed (8,760 hours, N 256, f32) on a row cut
(``--year-rows``, 122,175 by default: an eighth of 977,400), and K2's d =
3 sketch (the week in bf16, N 384, a bf16 Yc).  Beside the variants, in
the same run: one library call of the same product (``torch.mm(x, w)``;
bf16 K6 with ``out_dtype=torch.float32``, the sketch in its out dtype),
x read once (``x.sum()``) and out written once (``out.fill_``).  With
the new launchers each row names the block that
``ops.matmul.matmul_block`` chose, and where K6's rows are 16-byte but
not 32-byte aligned at a narrow width (15c's K 100) times the table's
other copy path there (``bulk_ms``).  Prints ptxas' registers and spill
bytes of the kernels' instantiations, one JSON line a shape, then the
card's name and power limit.  Needs one CUDA card, nvcc and ~45 GB of
the card's memory (the week's X and its Yc at N 256).
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
WEEK = 721 * 1440 * 15

# The edits of each variant, every occurrence replaced; a list of
# alternatives, the first whose texts are all in the tree's source taken
# (the mainloop before and after its redesign mark its lines otherwise).
MMA = [("wgmma_tf32(d", "if (0) wgmma_tf32(d"), ("wgmma_bf16(d", "if (0) wgmma_bf16(d")]
STORES = [("static_cast<bf16*>(out)[o] = ", "if (0) static_cast<bf16*>(out)[o] = "),
          ("static_cast<float*>(out)[o] = ", "if (0) static_cast<float*>(out)[o] = ")]
EDITS = {
    "no_mma": [MMA],
    "no_store": [
        STORES + [("*reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) = ",
                   "if (0) *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) = "),
                  ("*reinterpret_cast<float4*>(static_cast<float*>(out) + o) =",
                   "if (0) *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =")],
        STORES],
    "no_copy": [
        # the redesigned mainloop: each copy marked, each wait on one skipped
        [("issue(s);  // copy", ";"), ("issue(nxt);  // copy", ";"),
         ("fill(st, row0, col0);  // copy", ";"),
         ("mbar_wait(smem_u32(bars + s), phase);  // copy", ";")],
        # the parent's
        [("for (int s = 0; s < STAGES && s < jobs; ++s) issue(s);", ""),
         ("mbar_wait(smem_u32(bars + s), (uint32_t)((j / STAGES) & 1));", ""),
         ("if (tid == 0 && j + STAGES < jobs) issue(j + STAGES);", ""),
         ("fill(st, row0, col0);", "")],
    ],
    "no_stats": [[("if constexpr (CENTER) row_stats(", "if constexpr (false) row_stats(")],
                 [("chunk_row_stats<T>(st, tid, ca.square_in_storage, rsum, ssum);", "")]],
    "chained": [
        [("q == 0 ? 0 : 1", "ci == 0 && q == 0 ? 0 : 1"),
         ("acc[i] += d[i];  // restart", "acc[i] = d[i];")],
        [("q == 0 ? 0 : 1", "ci == 0 && q == 0 ? 0 : 1"),
         ("for (int i = 0; i < NACC; ++i) acc[i] += d[i];",
          "for (int i = 0; i < NACC; ++i) acc[i] = d[i];")],
    ],
}
LIBS = {"K6": ("matmul", ("kernel", "no_mma", "no_store", "no_copy", "chained")),
        "sketch": ("sketch_center_gram_project", ("kernel", "no_mma", "no_store", "no_copy",
                                                  "no_stats"))}


def source(tree: Path, lib: str, name: str) -> str | None:
    """``lib``.cu of ``tree`` with matmul_tc.cuh inlined and the variant's
    edits, or None where no alternative of them is in the source."""
    csrc = tree / "dmd_era5_tpu_torch" / "ops" / "csrc"
    src = (csrc / f"{lib}.cu").read_text()
    src = src.replace('#include "matmul_tc.cuh"', (csrc / "matmul_tc.cuh").read_text(), 1)
    if name == "kernel":
        return src
    for alt in EDITS[name]:
        if all(old in src for old, _ in alt):
            for old, new in alt:
                src = src.replace(old, new)
            return src
    return None


def build(tree: Path, out: Path, nvcc: str, flags: list[str], csrc: Path, lib: str, name: str):
    """The variant's library, or None (its log printed) where nvcc fails or
    the edit does not apply: the other variants are still timed."""
    src = source(tree, lib, name)
    if src is None:
        print(json.dumps({"lib": lib, "variant": name, "skipped": "edit not in the source"}),
              flush=True)
        return None
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{lib}_{name}.cu", out / f"lib{lib}_{name}.so"
    cu.write_text(src)
    proc = subprocess.run([nvcc, *flags, "-I", str(csrc), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    (out / f"{lib}_{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        print(json.dumps({"lib": lib, "variant": name, "nvcc_exit": proc.returncode,
                          "stderr_tail": proc.stderr[-3000:]}), flush=True)
        return None
    return ctypes.CDLL(str(so))


def ptxas(log: Path) -> dict:
    """Registers and spill bytes ptxas gave each matmul_tc instantiation."""
    lines = log.read_text().splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "matmul_tc" in line:
            kernel = line.split("'")[1]
            tail = " ".join(lines[i + 1:i + 6])
            regs = re.search(r"Used (\d+) registers", tail)
            spill = re.search(r"(\d+) bytes spill stores", tail)
            out[kernel] = [int(regs.group(1)) if regs else None,
                           int(spill.group(1)) if spill else None]
    return out


def ring_8(rule, m, k, n, dtype, center=False, **kw):
    """The block of ``rule`` (matmul_block) with its ring as deep as the
    shared memory holds, up to the kernel's 8 slots, where that is deeper
    than the rule's; else None."""
    from dmd_era5_tpu_torch.ops import matmul

    blk = rule(m, k, n, dtype, center, **kw)
    if blk.stream or blk.load == "elem":
        return None
    size = 4 if dtype == torch.float32 else 2
    fixed = matmul._mm_smem(blk.load, size, k, blk.n, blk.panel, 0)
    slot = matmul._mm_smem(blk.load, size, k, blk.n, blk.panel, 1) - fixed
    deep = min(matmul._MM_MAX_STAGES, (matmul._MM_SMEM_CAP - fixed) // slot)
    if deep <= blk.stages:
        return None
    return blk._replace(stages=deep, smem=matmul._mm_smem(blk.load, size, k, blk.n, blk.panel,
                                                          deep))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(ROOT), help="checkout whose kernels are timed")
    parser.add_argument("--year-rows", type=int, default=977_400 // 8)
    parser.add_argument("--only", choices=("K6", "sketch"), default=None)
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(ROOT)]  # the tree's package; chip_smoke's helpers
    from chip_smoke import device_ms
    from dmd_era5_tpu_torch.ops import _build, _occupancy, matmul

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    label = str(tree.relative_to(ROOT)) if tree.is_relative_to(ROOT) else str(tree)
    out_dir = ROOT / "build" / "k6_phases" / tree.name
    csrc = tree / "dmd_era5_tpu_torch" / "ops" / "csrc"
    parts = [p for p in LIBS if args.only in (None, p)]
    jobs = [(lib, name) for p in parts for lib, names in [LIBS[p]] for name in names]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = pool.map(lambda j: build(tree, out_dir, _build._nvcc(), _build.NVCC_FLAGS, csrc,
                                         *j), jobs)
        libs = {job: so for job, so in zip(jobs, built) if so is not None}
    for lib, _ in LIBS.values():
        if (lib, "kernel") in {j for j in jobs} and (lib, "kernel") not in libs:
            raise SystemExit(f"{lib}: the kernel itself did not build")
        if (out_dir / f"{lib}_kernel.log").exists():
            print(json.dumps({"tree": label, "lib": lib, "ptxas_registers_spill_bytes":
                              ptxas(out_dir / f"{lib}_kernel.log")}), flush=True)

    def use(lib: str, so) -> None:
        _build._LOADED[lib] = so
        matmul._MM_LIB = matmul._LIB = None
        _occupancy._RESIDENT.clear()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def yardsticks(row, x, w, out, mm, reps):
        row["library_ms"] = device_ms(mm, reps=reps)
        row["read_x_ms"] = device_ms(lambda: x.sum(), reps=reps)
        row["write_out_ms"] = device_ms(lambda: out.fill_(1.0), reps=reps)

    if "K6" in parts:
        k6_shapes = (  # label, M, K, N, dtype
            ("16e", 1_038_240, 97, 40, f32),
            ("16d_block", 65_536, 97, 20, f32),
            ("15c_UL", 2 * WEEK, 100, 24, f32),
            ("week_block_f32", 65_536, 168, 110, f32),
            ("week_block_bf16", 65_536, 168, 110, bf16),
            ("15a_block", 65_536, 168, 128, f32),
            ("lift_chunk", 1 << 21, 124, 100, f32),
        )
        for name, m, k, n, dtype in k6_shapes:
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            w = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            row = {"kernel": "K6", "shape": name, "m": m, "k": k, "n": n,
                   "dtype": str(dtype)[6:], "tree": label}
            if hasattr(matmul, "matmul_block"):
                row["block"] = matmul.matmul_block(m, k, n, dtype)._asdict()
            reps = 20 if m * k < 1 << 28 else 5
            out = None
            for variant in LIBS["K6"][1]:
                so = libs.get(("matmul", variant))
                if so is None:
                    continue
                use("matmul", so)
                out = matmul._matmul_cuda(x, w, f32)
                if variant in ("kernel", "chained"):
                    ref = x.float() @ w.float()
                    exact = x.double() @ w.double()
                    scale = float(exact.abs().max())
                    row[f"{variant}_vs_f64"] = float((out.double() - exact).abs().max()) / scale
                    if variant == "kernel":
                        row["plain_vs_f64"] = float((ref.double() - exact).abs().max()) / scale
                    del ref, exact
                row[f"{variant}_ms"] = device_ms(lambda: matmul._matmul_cuda(x, w, f32), reps=reps)
            use("matmul", libs[("matmul", "kernel")])
            if hasattr(matmul, "matmul_block") and k % 8 and n <= 80 and dtype == f32 \
                    and row["block"]["load"] == "tma":
                # the table's other copy path there: whole tiles by bulk copies
                alt = matmul.matmul_block(m, k, n, dtype, load="bulk")
                row["bulk_block"] = alt._asdict()
                row["bulk_ms"] = device_ms(lambda: matmul._matmul_cuda(x, w, f32, alt), reps=reps)
            deeper = (ring_8(matmul.matmul_block, m, k, n, dtype) if hasattr(matmul, "_MM_RING")
                      else None)
            if deeper is not None:  # the ring as deep as the shared memory holds, to 8
                row["ring_8_ms"] = device_ms(lambda: matmul._matmul_cuda(x, w, f32, deeper),
                                             reps=reps)
            mm = ((lambda: torch.mm(x, w, out_dtype=f32)) if dtype == bf16
                  else (lambda: torch.mm(x, w)))
            yardsticks(row, x, w, out, mm, reps)
            print(json.dumps(row), flush=True)
            del x, w, out
            torch.cuda.empty_cache()

    if "sketch" in parts:
        scalar = dict(center=True, stats_col=False, scalar_stats=True, t_valid=None,
                      emit_yc=True)
        plain = dict(center=False, stats_col=False, scalar_stats=False, t_valid=None,
                     emit_yc=True)
        sk_shapes = (  # label, M, T, N, X's dtype, Yc's dtype, flags, stages (7 K1, 3 K2)
            ("bench_bf16", 1 << 19, 512, 128, bf16, bf16, scalar, 7),
            ("bench_f32", 1 << 19, 512, 128, f32, f32, scalar, 7),
            ("config2_n76", 1_038_240, 97, 76, f32, f32, plain, 7),
            ("week_fit_bf16", WEEK, 168, 128, bf16, bf16, scalar, 7),
            ("week_hankel_f32", WEEK, 168, 256, f32, f32, plain, 7),
            ("year_cut_streamed", args.year_rows, 8760, 256, f32, f32, plain, 7),
            ("d3_k2_bf16", WEEK, 168, 384, bf16, bf16, dict(plain, center=True), 3),
        )
        for name, m, t, n, dtype, out_dtype, flags, stages in sk_shapes:
            x = torch.randn((m, t), generator=gen, device=dev).to(dtype)
            w = torch.randn((t, n), generator=gen, device=dev).to(dtype)
            row = {"kernel": "K1 sketch" if stages == 7 else "K2 sketch", "shape": name, "m": m,
                   "t": t, "n": n, "dtype": str(dtype)[6:], "out": str(out_dtype)[6:],
                   "tree": label}
            if hasattr(matmul, "matmul_block"):
                row["block"] = matmul.matmul_block(m, t, n, dtype, center=True)._asdict()
            reps = 20 if m * t < 1 << 28 else 5
            yc = None
            for variant in LIBS["sketch"][1]:
                so = libs.get(("sketch_center_gram_project", variant))
                if so is None:
                    continue
                use("sketch_center_gram_project", so)
                res, run = matmul._scgp_plan(x, w, out_dtype, **flags, stages=stages)
                run(1)
                if variant == "kernel":
                    ref = (x.float() @ w.float()).to(out_dtype)
                    row["yc_uncentred_rel_vs_plain"] = (
                        float((res["yc"].float() - ref.float()).norm() / ref.float().norm())
                        if not flags["center"] else None)
                    del ref
                row[f"{variant}_ms"] = device_ms(lambda: run(1), reps=reps)
                yc = res["yc"]
                del res, run
            use("sketch_center_gram_project", libs[("sketch_center_gram_project", "kernel")])
            rule = getattr(matmul, "matmul_block", None)
            if hasattr(matmul, "_MM_RING") and ring_8(rule, m, t, n, dtype, True) is not None:
                # the ring as deep as the shared memory holds, to 8
                matmul.matmul_block = lambda *a, **kw: ring_8(rule, *a, **kw) or rule(*a, **kw)
                res, run = matmul._scgp_plan(x, w, out_dtype, **flags, stages=stages)
                row["ring_8_ms"] = device_ms(lambda: run(1), reps=reps)
                del res, run
                matmul.matmul_block = rule
            mm = lambda: torch.mm(x, w)  # noqa: E731  (x's dtype: the stage's out dtype here)
            yardsticks(row, x, w, yc, mm, reps)
            print(json.dumps(row), flush=True)
            del x, w, yc
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
