"""The tile tables of K4, K5, K1 and K2 on the card, measured.

    python scripts/torch_tc_tables.py [--parts gram,split,sketch,long_t,bench]

Each table lives in its library (``atb_tc::gram_edge`` in
``csrc/row_share_atb_tc.cuh`` for K4 and K1's G stage, which picks its
own block edge; ``ops/matmul.py::matmul_block`` for K1's sketch, whose
columns a CTA and streaming of W the launcher passes in).  This script
builds variants of the sources, each with a table replaced by one fixed
choice (the edited header inlined, the flags of ``ops/_build.py``, into
``build/tc_tables/``), or fixes the sketch's block in ``matmul_block``'s
place, and runs each through the package's own wrapper (the variant put
in place of the library the wrapper loads), beside the library and the
rule as they are (``table``).

K4's block edge: ``gram(a, "highest")`` (3xTF32 wgmma with ``upper``) on
f32 panels of the ERA5 week's row count at the widths the main path gives
it and K1's G stage: K 110 (the 110-column sketch), 128 and 256 (the fit
step's and the Hankel pass's Yc) and 168 (the week's X), at block edge
128 and 64, beside one ``a.T @ a`` (f32, TF32 off); G of each edge
against the f64 sums.

K5's block edge (``split``): ``gram(a, "bf16_split")`` (the wgmma kernel
of ``csrc/gram_split_wgmma.cuh``, table ``split_edge`` in ``gram.cu``) at
block edge 128 and 64 on f32 panels at K 64, 96, 110 (the sketch; its
rows through registers), 168 (the week's X, by TMA) and 256 at the week's
row count, K 96 at a CholQR2 leaf's 4,096 rows (phase 20) and K 8,760 at
the hourly year's (977,400 rows, by TMA), beside
``table`` and one ``a.T @ a``; G of each edge against the f64 sums (not at
the year, where the f64 sums take seconds).

K1's sketch columns: K1's sketch stage alone (the wrapper's plan,
``_scgp_plan``) on an X of the week's shape at N 100, 128, 224 and 256 in
f32 and N 128 in bf16, at 112 and 128 columns a CTA; Yc must be the same
bit for bit.  Then the bf16 sketch's Y (its MMA sums restarted every k16
step) against the f64 product, beside the f32 library product's.

The sketch's time axis (``long_t``), ``matmul_block``'s choice to stream
W: an f32 sketch either holds W in shared
memory (resident, or past its depth restaged in panels every tile and
panel) or streams it (split once a call into tf32 chunks that ride the
ring beside X's).  On the hourly year's X (977,400 x 8,760 f32, 34 GB)
at K2's widths there, N 256 and 128, the sketch stage alone (the
wrapper's plan for K2, ``stages=3``) as it is (``table``), with W held
(``w_held``), streamed (``w_streamed``), and held with the restage
skipped after a CTA's first panel (``restage_skipped``: every panel's MMAs
read the first one, so its Yc means nothing; timing only): the last two
against ``w_held`` say what the restage costs and what streaming saves.
The held and streamed Yc must be the same bit for bit.  Then held against
streamed over T from 168 to 2,048 at the week's elements (M T about
2.6e9, N 128 and 256), which sets the table's edge.

K3's block table (``project.cu``, ``ops/matmul.py::project_block``) is
timed by ``scripts/torch_k3_phases.py`` and ``scripts/torch_k3_times.py``.

The bench's shape (``bench``), where the TPU tile sweeps ran
(``scripts/kernel_tune.py``, ``pass1_tune.py``, ``fused_tune2.py``,
``pass1_variants.py``: S = 2^19, T = 512, r = 128), in f32 and bf16: K1
as the fit step launches it (centred, scalar statistics) with its sketch
at 112 and 128 columns a CTA and, in f32, W held and streamed (the table
streams it past T 176), Yc the same bit for bit; K1's G stage alone and
K4 (``gram(yc, "highest")``) on its Yc at block edge 128 and 64 (f32; the
bf16 kernels have 128 only), G against the f64 sums, beside one library
product (``yc.T @ yc``); the sketch stage beside one ``torch.mm(x, w)``,
and both stages' bounds (``chip_smoke.bound``'s formulas).

Device ms by ``chip_smoke.device_ms`` (launches queued behind a sleep of
the card).  Prints one JSON line a shape and the card's name and power
limit.  Needs one CUDA card, nvcc and about 36 GB of the card's memory;
~2 min.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import PEAK_BF16, PEAK_TF32, bound, device_ms, gram_f64, rel_err  # noqa: E402
from dmd_era5_tpu_torch.ops import _build, _occupancy, matmul, qr_panel  # noqa: E402

M = 721 * 1440 * 15  # the ERA5 week's rows
OUT = ROOT / "build" / "tc_tables"
GRAM_TABLE = ("inline int gram_edge(bool bf16, int k) "
              "{ return !bf16 && k > 128 && k <= 192 ? 64 : wg::BT; }")
RESTAGE = "    if (!STREAM && (j == 0 || (paneled && col0 == kp0))) {"
SPLIT_TABLE = "int split_edge(int k) { return k <= 96 || (k > 128 && k <= 192) ? 64 : 128; }"
YEAR = (181 * 360 * 15, 8760)  # the hourly 1-degree year's rows and hours
BENCH = (1 << 19, 512, 128)  # S, T, r of the TPU sweeps and of the fit-step bench
SCG = ("sketch_center_gram_project", "sketch_center_gram_project.cu")
# variant name: (library, source, header(s) inlined, [(table, fixed choice), ...])
VARIANTS = {
    f"gram_edge{e}": ("gram", "gram.cu", ("gram_split_wgmma.cuh", "matmul_tc.cuh",
                                          "row_share_atb_tc.cuh"), [(GRAM_TABLE, (
        f"inline int gram_edge(bool bf16, int k) {{ return bf16 ? wg::BT : {e}; }}"))])
    for e in (128, 64)
} | {
    f"split_edge{e}": ("gram", "gram.cu", None, [(SPLIT_TABLE, (
        f"int split_edge(int k) {{ return {e}; }}"))])
    for e in (128, 64)
} | {
    f"scg_gram_edge{e}": (*SCG, ("matmul_tc.cuh", "row_share_atb_tc.cuh"), [(GRAM_TABLE, (
        f"inline int gram_edge(bool bf16, int k) {{ return bf16 ? wg::BT : {e}; }}"))])
    for e in (128, 64)
} | {
    "restage_skipped": (*SCG, "matmul_tc.cuh", [(RESTAGE, "    if (!STREAM && j == 0) {")]),
}
# the sketch's block fixed in matmul_block's place (restage_skipped: W held)
BLOCKS = {"sketch_columns112": dict(width=112), "sketch_columns128": dict(width=128),
          "w_held": dict(stream=False), "w_streamed": dict(stream=True),
          "restage_skipped": dict(stream=False)}
RULE = matmul.matmul_block


def build(name: str):
    """The variant's library, built."""
    _, source, headers, edits = VARIANTS[name]
    src = (_build.CSRC_DIR / source).read_text()
    for header in (headers,) if isinstance(headers, str) else headers or ():
        # in order: a header inlined may include the next one
        src = src.replace(f'#include "{header}"', (_build.CSRC_DIR / header).read_text())
    for table, fixed in edits:
        if table not in src:
            raise SystemExit(f"{name}: the table is no longer '{table}'")
        src = src.replace(table, fixed)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(so))


def use(library: str, lib, block: str | None = None) -> None:
    """The wrappers load ``lib`` as ``library`` from here on, and the
    sketch takes the block that ``BLOCKS[block]`` fixes (the rule's where
    None)."""
    matmul.matmul_block = functools.partial(RULE, **BLOCKS.get(block, {}))
    _build._LOADED[library] = lib
    qr_panel._LIB = None
    matmul._LIB = None
    matmul._PROJECT_LIB = None
    _occupancy._RESIDENT.clear()


def gram_part(libs, tables, gen, dev) -> None:
    for k in (110, 128, 168, 256):
        a = torch.randn((M, k), generator=gen, device=dev)
        exact = gram_f64(a)
        row = {"m": M, "k": k}
        for name, lib in (("edge128", libs["gram_edge128"]), ("edge64", libs["gram_edge64"]),
                          ("table", tables["gram"])):
            use("gram", lib)
            g = qr_panel.gram(a, "highest")
            row[f"rel_vs_f64_{name}"] = rel_err(g, exact)[0]
            row[f"symmetric_{name}"] = bool(torch.equal(g, g.T))
            row[f"device_ms_{name}"] = device_ms(lambda: qr_panel.gram(a, "highest"), reps=5)
        row["library_device_ms"] = device_ms(lambda: a.T @ a, reps=5)
        print(json.dumps(row), flush=True)
        del a, exact


def split_part(libs, tables, gen, dev) -> None:
    for m, k in ((M, 64), (M, 96), (4096, 96), (M, 110), (M, 168), (M, 256), YEAR):
        a = torch.randn((m, k), generator=gen, device=dev)
        exact = gram_f64(a) if k <= 256 else None
        reps = 2 if exact is None else 5
        row = {"m": m, "k": k}
        for name, lib in (("edge128", libs["split_edge128"]), ("edge64", libs["split_edge64"]),
                          ("table", tables["gram"])):
            use("gram", lib)
            g = qr_panel.gram(a, "bf16_split")
            if exact is not None:
                row[f"max_abs_vs_f64_over_max_{name}"] = float(
                    (g.double() - exact).abs().max() / exact.abs().max())
            row[f"symmetric_{name}"] = bool(torch.equal(g, g.T))
            del g
            row[f"device_ms_{name}"] = device_ms(lambda: qr_panel.gram(a, "bf16_split"), reps=reps)
        row["library_device_ms"] = device_ms(lambda: a.T @ a, reps=reps)
        print(json.dumps(row), flush=True)
        del a, exact
        torch.cuda.empty_cache()


def sketch_part(libs, tables, gen, dev) -> None:
    x = torch.randn((M, 168), generator=gen, device=dev)
    for n, dtype in ((256, torch.float32), (224, torch.float32), (128, torch.float32),
                     (100, torch.float32), (128, torch.bfloat16)):
        xt = x.to(dtype)
        w = torch.randn((168, n), generator=gen, device=dev).to(dtype)
        row = {"m": M, "t": 168, "n": n, "dtype": str(dtype)[6:]}
        ycs = {}
        for name, block in (("112", "sketch_columns112"), ("128", "sketch_columns128"),
                            ("table", None)):
            use("sketch_center_gram_project", tables["sketch_center_gram_project"], block)
            out, run = matmul._scgp_plan(xt, w, dtype, True, False, True, None, True)
            run(7)
            ycs[name] = out["yc"]
            row[f"sketch_device_ms_{name}"] = device_ms(lambda run=run: run(1), reps=5)
            del out, run
        row["yc_equal"] = all(torch.equal(ycs["112"], yc) for yc in ycs.values())
        print(json.dumps(row), flush=True)
        del xt, w, ycs
    # the bf16 sketch's Y (no centring, f32 out) against the f64 product, on
    # the first 2^18 rows, beside the f32 library product of the same values
    use("sketch_center_gram_project", tables["sketch_center_gram_project"])
    xb = x[: 1 << 18].bfloat16()
    wb = torch.randn((168, 128), generator=gen, device=dev).bfloat16()
    exact = xb.double() @ wb.double()
    y = matmul.sketch_center_gram_project(xb, wb, out_dtype=torch.float32, center=False)[0]
    print(json.dumps({"bf16_sketch_rows": xb.shape[0], "t": 168, "n": 128,
                      "kernel_y_rel_vs_f64": rel_err(y, exact)[0],
                      "library_f32_y_rel_vs_f64": rel_err(xb.float() @ wb.float(), exact)[0]}))


def sketch_times(x, w, variants, libs, tables) -> dict:
    """The K2 sketch stage's device ms alone on x and w with each variant
    (``table``: the library as it is), and whether the Yc of every variant
    but ``restage_skipped`` is the table's bit for bit."""
    row, ref, equal = {}, None, True
    for name in variants:  # the table first
        use("sketch_center_gram_project", libs.get(name, tables["sketch_center_gram_project"]),
            name)
        out, run = matmul._scgp_plan(x, w, torch.float32, False, False, False, None, True,
                                     stages=3)
        run(3)
        if ref is None:
            ref = out["yc"].clone()
        elif name != "restage_skipped":
            equal = equal and torch.equal(out["yc"], ref)
        row[f"sketch_device_ms_{name}"] = device_ms(lambda run=run: run(1), reps=3)
        del out, run
    row["yc_equal"] = equal
    return row


def long_t_part(libs, tables, gen, dev) -> None:
    x = torch.randn(YEAR, generator=gen, device=dev)
    for n in (256, 128):
        w = torch.randn((YEAR[1], n), generator=gen, device=dev)
        row = {"m": YEAR[0], "t": YEAR[1], "n": n, "dtype": "float32",
               **sketch_times(x, w, ("table", "w_held", "w_streamed", "restage_skipped"),
                              libs, tables)}
        held = row["sketch_device_ms_w_held"]
        row["restage_share_of_held"] = 1 - row["sketch_device_ms_restage_skipped"] / held
        row["streamed_over_held"] = row["sketch_device_ms_w_streamed"] / held
        print(json.dumps(row), flush=True)
        del w
    del x
    torch.cuda.empty_cache()
    for t in (168, 176, 192, 336, 705, 2048):
        x = torch.randn((2_600_000_000 // t, t), generator=gen, device=dev)
        for n in (128, 256):
            w = torch.randn((t, n), generator=gen, device=dev)
            row = {"m": x.shape[0], "t": t, "n": n, "dtype": "float32",
                   **sketch_times(x, w, ("table", "w_held", "w_streamed"), libs, tables)}
            row["streamed_over_held"] = (row["sketch_device_ms_w_streamed"]
                                         / row["sketch_device_ms_w_held"])
            print(json.dumps(row), flush=True)
            del w
        del x


def bench_part(libs, tables, gen, dev) -> None:
    m, t, n = BENCH
    scg = "sketch_center_gram_project"
    x = torch.randn((m, t), generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        xt = x.to(dtype)
        w = torch.randn((t, n), generator=gen, device=dev).to(dtype)
        row = {"shape": "bench", "m": m, "t": t, "n": n, "dtype": str(dtype)[6:]}
        variants = [("112", "sketch_columns112"), ("128", "sketch_columns128"), ("table", None)]
        if not bf16:
            variants += [("w_held", "w_held"), ("w_streamed", "w_streamed")]
        ycs = {}
        for name, key in variants:
            use(scg, tables[scg], key)
            out, run = matmul._scgp_plan(xt, w, dtype, True, False, True, None, True)
            run(7)
            ycs[name] = out["yc"].clone()
            row[f"sketch_device_ms_{name}"] = device_ms(lambda run=run: run(1), reps=5)
            del out, run
        row["yc_equal"] = all(torch.equal(ycs["table"], yc) for yc in ycs.values())
        # the sketch stage's bound (chip_smoke.bound: X W, three TF32 passes
        # in f32, one bf16 pass; X and W read, Yc written) and one library
        # product of the same operands
        size = xt.element_size()
        row["sketch_bound_ms"], row["sketch_bound_by"] = bound(
            (1 if bf16 else 3) * 2 * m * n * t, PEAK_BF16 if bf16 else PEAK_TF32,
            size * (m * t + t * n + m * n))
        row["sketch_library_device_ms"] = device_ms(lambda: torch.mm(xt, w), reps=5)
        yc = ycs["table"]
        del ycs
        exact = gram_f64(yc)
        edges = [("edge128", 128), ("table", None)] + ([] if bf16 else [("edge64", 64)])
        for name, e in edges:  # K1's G stage alone: mask 2 of one plan's buffers
            use(scg, libs[f"scg_gram_edge{e}"] if e else tables[scg])
            out, run = matmul._scgp_plan(xt, w, dtype, True, False, True, None, True)
            run(7)
            row[f"k1_G_rel_vs_f64_{name}"] = rel_err(out["g"], gram_f64(out["yc"]))[0]
            row[f"k1_G_device_ms_{name}"] = device_ms(lambda run=run: run(2), reps=5)
            del out, run
            use("gram", libs[f"gram_edge{e}"] if e else tables["gram"])
            g = qr_panel.gram(yc, "highest")
            row[f"k4_rel_vs_f64_{name}"] = rel_err(g, exact)[0]
            row[f"k4_device_ms_{name}"] = device_ms(lambda: qr_panel.gram(yc, "highest"), reps=5)
        use("gram", tables["gram"])
        use(scg, tables[scg])
        yf = yc.float()
        row["library_device_ms"] = device_ms(lambda: yf.T @ yf, reps=5)
        # the G stage's and K4's bound (chip_smoke's K4 formula on Yc)
        row["gram_bound_ms"], row["gram_bound_by"] = bound(
            (1 if bf16 else 3) * m * n * (n + 1), PEAK_BF16 if bf16 else PEAK_TF32,
            yc.element_size() * m * n + 4 * n * n)
        print(json.dumps(row), flush=True)
        del xt, w, yc, yf, exact
        torch.cuda.empty_cache()


PARTS = {"gram": gram_part, "split": split_part, "sketch": sketch_part, "long_t": long_t_part,
         "bench": bench_part}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parts", default=",".join(PARTS),
                        help=f"comma-separated, of {', '.join(PARTS)}")
    parts = parser.parse_args().parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(VARIANTS) + 2) as pool:
        tables = {lib: pool.submit(_build.load_kernel_library, lib)
                  for lib in ("gram", "sketch_center_gram_project")}
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
        tables = {lib: fut.result() for lib, fut in tables.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    for part in parts:
        PARTS[part](libs, tables, gen, dev)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
