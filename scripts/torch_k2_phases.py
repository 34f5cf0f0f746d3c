"""Where the time of K2 on thread-block clusters (``sketch_center_gram`` on
``csrc/sketch_center_gram.cu``) goes on the card: device ms of variants of
its source that each drop one phase.

    python scripts/torch_k2_phases.py [--only LABEL,LABEL] [--gram-cluster N,N]

Each variant is the package's ``ops/csrc`` with one edit (every file that
holds the edited text), built by ``nvcc`` (the flags of ``ops/_build.py``)
into ``build/k2_phases/<variant>/`` and bound through ``ops.k2.bind``:

    kernel     the source as it is
    no_mma     no MMA: each wgmma instruction, fence, commit and wait
               commented out of its asm (timing only)
    l2_copy    every copy reads the first tile or slab (from L2), so no
               copy reads device memory; the ring's protocol as it is
               (timing only: a variant without copies lets a CTA run ahead
               of its cluster, and the barriers' phases no longer line up)
    no_store   the sketch stores no Yc (timing only)
    no_stats   the sketch sums no row statistics from its chunks (timing
               only)
    no_fold    the Gram folds its f32 sums into f64 never but at the end
               (timing only)
    chain64    the sketch's four k16 steps a chunk in one chain from zero
               (64 columns of T a restart; the source restarts every 32)
    xchg2      the sketch plus the Yc exchange of the fused design: after
    xchg5      each tile's store, a CTA copies its staged 128 x 64 block of
               Yc into 2 (5: every other CTA's, an all-gather) partners'
               shared memory over the cluster (``cp.async.bulk
               .shared::cluster``), a warp of each partner's producer
               warpgroup waits for the blocks and releases them; the
               sender waits for the releases of its previous block.  2
               partner blocks are the least that design needs at the
               sketch's cluster of 6 (a CTA's share of G's upper half
               touches >= 157 of Yc's 384 columns, 64 its own), 5 all.
               Nothing reads the blocks (timing only); xchg5's 80 KB of
               blocks leave a ring of 5 slots, so the source is also timed
               at 5 (``sketch_ring5``)

Shapes, Gaussian from a seed on the card: bf16 X at the week's rows
(15,573,600 x 168) with N 384 (the d = 3 pass, no centring) and N 512, and
the narrowest width of the route, N 264.  Each stage through the route's
plan (``ops.matmul._k2_plan``, ``run(1)`` the sketch, ``run(2)`` G) after one
whole call has filled Yc, beside the library calls of each stage
(``torch.mm(x, w)``; ``torch.mm(yc.T, yc, out_dtype=torch.float32)``) and
the operands read once (``x.sum()``, ``yc.sum()``: the bytes floor).
``--gram-cluster`` also times the kernel's Gram at other cluster sizes of
``ops/k2.py::gram_plan``.  Each variant runs in a process of its own, so
one that faults is reported and the others still run.  Prints ptxas'
registers and spill bytes, one JSON line a shape, then the card's name and
power limit.  The source and ``chain64`` also give ``yc_flips``: the
share of Yc's first 2^20 rows whose bf16 value differs from the plain
version's (``matmul._sketch_center_gram_plain``) and ``yc_flips_f64``, from
the f64 product's rounding.  Needs one CUDA card, nvcc and ~40 GB of the
card's memory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms  # noqa: E402
from dmd_era5_tpu_torch.ops import _build, k2, matmul  # noqa: E402

WEEK = 721 * 1440 * 15
SHAPES = [("d3_N384", WEEK, 168, 384), ("d4_N512", WEEK, 168, 512), ("N264", WEEK, 168, 264)]
VARIANTS = ("kernel", "no_mma", "l2_copy", "no_store", "no_stats", "no_fold", "chain64", "xchg2",
            "xchg5")
FLIP_ROWS = 1 << 20
# the sketch's ring of X's chunks where a variant's shared memory leaves fewer slots
RING = {"xchg5": 5}


def exchange(partners: int) -> list[tuple[str, str]]:
    """The edits of an ``xchg`` variant: each tile's staged Yc block copied
    into ``partners`` other CTAs' shared memory and released by them."""
    return [
        ("constexpr int MAX_PLAN = 32;\nconstexpr int SMEM_CAP = 232448;",
         f"constexpr int MAX_PLAN = 32;\nconstexpr int SMEM_CAP = 232448;\nconstexpr int XP = {partners};"),
        ("  return 1024 + ring * CHUNK + kw_of(t) * BN * 2 + 2 * STAGE + BM * 4 + BARS;",
         "  return 1024 + ring * CHUNK + kw_of(t) * BN * 2 + (2 + XP) * STAGE + BM * 4 + BARS + 16;"),
        ("  float* mu = reinterpret_cast<float*>(staged + 2 * STAGE);",
         "  unsigned char* rx = staged + 2 * STAGE;\n"
         "  float* mu = reinterpret_cast<float*>(rx + XP * STAGE);"),
        ("  uint64_t* full = reinterpret_cast<uint64_t*>(mu + BM);\n  uint64_t* empty = full + MAX_RING;\n",
         "  uint64_t* full = reinterpret_cast<uint64_t*>(mu + BM);\n  uint64_t* empty = full + MAX_RING;\n"
         "  uint64_t* rx_full = empty + MAX_RING;\n  uint64_t* tx_empty = rx_full + 1;\n"),
        ("      mbar_init(smem_u32(empty + s), 2 * cl);      // each consumer warpgroup of the cluster, "
         "once a use\n    }\n",
         "      mbar_init(smem_u32(empty + s), 2 * cl);      // each consumer warpgroup of the cluster, "
         "once a use\n    }\n    mbar_init(smem_u32(rx_full), 1);\n"
         "    mbar_init(smem_u32(tx_empty), (uint32_t)max(1, min(XP, cl - 1)));\n"),
        (r'__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }',
         r'__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }'
         "\n__device__ __forceinline__ void dsmem_copy(uint32_t dst, uint32_t rank, uint32_t src, "
         "uint32_t bytes, uint32_t bar) {\n"
         r'  asm volatile("{\n.reg .b32 xd, xb;\nmapa.shared::cluster.u32 xd, %0, %1;\n'
         r'mapa.shared::cluster.u32 xb, %4, %1;\n"'
         "\n"
         r'               "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes '
         r'[xd], [%2], %3, [xb];\n}\n"'
         "\n"
         '               ::"r"(dst), "r"(rank), "r"(src), "r"(bytes), "r"(bar) : "memory");\n}'),
        ("          tma_store(&ymap, n0, (int)row0, smem_u32(stage));  // store\n          bulk_commit();\n",
         "          tma_store(&ymap, n0, (int)row0, smem_u32(stage));  // store\n          bulk_commit();\n"
         "          const int xp = min(XP, cl - 1);\n"
         "          if (it > 0) mm_tc::mbar_wait(smem_u32(tx_empty), (uint32_t)((it - 1) & 1));\n"
         "          for (int p = 1; p <= xp; ++p) {\n"
         "            dsmem_copy(smem_u32(rx + (p - 1) * STAGE), (uint32_t)((rank + p) % cl), "
         "smem_u32(stage), STAGE, smem_u32(rx_full));\n"
         "          }\n"),
        ("    if (tid == CONSUMERS) Feed{full, empty, a.ring, cl, rank}.run(jobs, CHUNK, copy);\n",
         "    if (tid == CONSUMERS) Feed{full, empty, a.ring, cl, rank}.run(jobs, CHUNK, copy);\n"
         "    if (tid == CONSUMERS + 32) {\n"
         "      const int xp = min(XP, cl - 1);\n"
         "      for (long long i = 0; i < my_tiles; ++i) {\n"
         "        mm_tc::mbar_expect_tx(smem_u32(rx_full), (uint32_t)(xp * STAGE));\n"
         "        mm_tc::mbar_wait(smem_u32(rx_full), (uint32_t)(i & 1));\n"
         "        for (int p = 1; p <= xp; ++p) arrive_at(smem_u32(tx_empty), (uint32_t)((rank - p + cl) % cl));\n"
         "      }\n"
         "    }\n"),
    ]


EDITS = {
    "no_mma": [(f'"{op}', f'"// {op}') for op in (
        "wgmma.mma_async.sync.aligned.m64n", "wgmma.fence.sync.aligned;",
        "wgmma.commit_group.sync.aligned;", "wgmma.wait_group.sync.aligned %0;")],
    "l2_copy": [("&xmap, c_chunk * 64, (int)c_row,", "&xmap, c_chunk * 64, 0,"),
                ("&ymap, 64 * k, r0,", "&ymap, 64 * k, 0,")],
    "no_store": [("          tma_store(&ymap, n0, (int)row0, smem_u32(stage));  // store",
                  "          (void)row0;")],
    "no_stats": [("      if (stats) mm_tc::chunk_row_stats<bf16>(st, tid, false, rsum, ssum);", "")],
    "no_fold": [("""      if (s & 1) {  // the staggered fold, beside the MMAs
        fold(std::integral_constant<int, 1>{});
      } else {
        fold(std::integral_constant<int, 0>{});
      }""", "")],
    "chain64": [("wgmma_ss<0, 1>(d[q >> 1],", "wgmma_ss<0, 1>(d[0],"),
                ("                       (q & 1) == 0 ? 0 : 1);", "                       q == 0 ? 0 : 1);")],
    "xchg2": exchange(2),
    "xchg5": exchange(5),
}


def build(out: Path, nvcc: str, name: str) -> Path | None:
    """The variant's library, or None (the log printed) where nvcc fails."""
    d = out / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(ROOT / "dmd_era5_tpu_torch" / "ops" / "csrc", d)
    for old, new in EDITS.get(name, []):
        hits = [f for f in d.iterdir() if old in f.read_text()]
        if not hits:
            raise SystemExit(f"{name}: no source holds {old!r}")
        for f in hits:
            f.write_text(f.read_text().replace(old, new))
    lib = d / "libsketch_center_gram.so"
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(d / "sketch_center_gram.cu")],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        print(f"[{name}] nvcc failed:\n{log[-3000:]}", flush=True)
        return None
    for line in log.splitlines():
        if name == "kernel" and ("Compiling entry" in line or "registers" in line or "spill" in line):
            print(f"    ptxas {line.strip()}", flush=True)
    return lib


def time_variant(name: str, lib: str, only: set, gram_clusters: list[int]) -> None:
    """One variant's device ms at every shape, in this process: one JSON line."""
    k2._LIB = k2.bind(ctypes.CDLL(lib))
    bf16 = torch.bfloat16
    mm = lambda p, q: torch.mm(p, q, out_dtype=torch.float32)  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, m, t, n in SHAPES:
        if only and label not in only:
            continue
        x = torch.randn((m, t), generator=gen, device="cuda").to(bf16)
        w = torch.randn((t, n), generator=gen, device="cuda").to(bf16)
        if name in RING:  # the route's block at the variant's ring, past the table
            block = k2.k2_block(m, t, n, bf16, bf16)._replace(sketch_ring=RING[name])
            o, run = k2.plan(x, w, w.float().sum(dim=0), 0.0, block)
        else:
            o, run, block = matmul._k2_plan(x, w, bf16, False, None)
        run(3)
        res = {"sketch": device_ms(lambda: run(1), 3), "G": device_ms(lambda: run(2), 3)}
        if name in ("kernel", "chain64"):
            xs = x[:FLIP_ROWS]
            ref = matmul._sketch_center_gram_plain(xs, w, bf16, False)[0]
            res["yc_flips"] = float((o["yc"][:FLIP_ROWS] != ref).double().mean())
            ref = (xs.double() @ w.double()).to(bf16)
            res["yc_flips_f64"] = float((o["yc"][:FLIP_ROWS] != ref).double().mean())
            del xs, ref
        if name == "kernel":
            ob, rb = k2.plan(x, w, w.float().sum(dim=0), 0.0, block._replace(sketch_ring=5))
            rb(1)
            res["sketch_ring5"] = device_ms(lambda: rb(1), 3)
            del ob, rb
            res["block"], res["grid"] = block._asdict(), o["grid"]
            for cl in gram_clusters:
                blk = block._replace(gram_cluster=cl, gram_plan=k2.gram_plan(n, cl))
                ob, rb = k2.plan(x, w, w.float().sum(dim=0), 0.0, blk)
                rb(3)
                res[f"G_cluster{cl}"] = device_ms(lambda: rb(2), 3)
                res[f"G_cluster{cl}_shares"] = ob["grid"]["gram_shares"]
                del ob, rb
            yc = o["yc"]
            res["library_sketch"] = device_ms(lambda: torch.mm(x, w), 3)
            res["library_G"] = device_ms(lambda: mm(yc.T, yc), 3)
            res["read_x"] = device_ms(lambda: x.sum(), 3)
            res["read_yc"] = device_ms(lambda: yc.sum(), 3)
            del yc
        out[label] = res
        del x, w, o, run
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="", help="comma-separated shape labels (default: all)")
    parser.add_argument("--gram-cluster", default="", help="comma-separated Gram cluster sizes")
    parser.add_argument("--variant", nargs=2, metavar=("NAME", "LIB"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    only = set(args.only.split(",")) - {""}
    clusters = [int(c) for c in args.gram_cluster.split(",") if c]
    if args.variant:
        time_variant(*args.variant, only, clusters)
        return
    out = ROOT / "build" / "k2_phases"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda v: build(out, nvcc, v), VARIANTS)))
    # each variant in a process of its own: a timing-only variant that faults
    # (its slots read as they are) is reported and leaves the others' context
    table: dict = {}
    for name, path in libs.items():
        if path is None:
            continue
        proc = subprocess.run([sys.executable, __file__, "--only", args.only, "--gram-cluster",
                               args.gram_cluster, "--variant", name, str(path)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"[{name}] failed:\n{proc.stderr[-1500:]}", flush=True)
            continue
        for label, res in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            row = table.setdefault(label, {})
            for key, val in res.items():
                row[key if key in ("block", "grid") or key.startswith(("G_cluster", "library", "read"))
                    else f"{name}_{key}"] = val
    for label, row in table.items():
        print(json.dumps({"label": label, **row}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
