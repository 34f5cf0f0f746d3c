"""The tile tables of K4 and K1 on the card, measured.

    python scripts/torch_tc_tables.py

Each table lives in its library (``atb_tc::gram_edge`` in
``csrc/row_share_atb_tc.cuh`` for K4 and K1's G stage, ``sketch_columns``
in ``csrc/sketch_center_gram_project.cu`` for K1's sketch), which picks
its own block edge or columns a CTA.  This script builds variants of the
two sources, each with the table replaced by one fixed choice (the edited
header inlined, the flags of ``ops/_build.py``, into
``build/tc_tables/``), and runs each through the package's own wrapper
(the variant put in place of the library the wrapper loads), beside the
library as it is (``table``).

K4's block edge: ``gram(a, "highest")`` (3xTF32 wgmma with ``upper``) on
f32 panels of the ERA5 week's row count at the widths the main path gives
it and K1's G stage: K 110 (the 110-column sketch), 128 and 256 (the fit
step's and the Hankel pass's Yc) and 168 (the week's X), at block edge
128 and 64, beside one ``a.T @ a`` (f32, TF32 off); G of each edge
against the f64 sums.

K1's sketch columns: K1's sketch stage alone (the wrapper's plan,
``_scgp_plan``) on an X of the week's shape at N 100, 128, 224 and 256 in
f32 and N 128 in bf16, at 112 and 128 columns a CTA; Yc must be the same
bit for bit.  Then the bf16 sketch's Y (its MMA sums restarted every k16
step) against the f64 product, beside the f32 library product's.

Device ms by ``chip_smoke.device_ms`` (launches queued behind a sleep of
the card).  Prints one JSON line a shape and the card's name and power
limit.  Needs one CUDA card, nvcc and about 30 GB of the card's memory;
~1.5 min.
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

from chip_smoke import device_ms, gram_f64, rel_err  # noqa: E402
from dmd_era5_tpu_torch.ops import _build, _occupancy, matmul, qr_panel  # noqa: E402

M = 721 * 1440 * 15  # the ERA5 week's rows
OUT = ROOT / "build" / "tc_tables"
GRAM_TABLE = ("inline int gram_edge(bool bf16, int k) "
              "{ return !bf16 && k > 128 && k <= 192 ? 64 : wg::BT; }")
SKETCH_TABLE = "int sketch_columns(int n) { return n <= 112 ? 112 : 128; }"
# variant name: (library, source, header inlined, table, fixed choice)
VARIANTS = {
    f"gram_edge{e}": ("gram", "gram.cu", "row_share_atb_tc.cuh", GRAM_TABLE,
                      f"inline int gram_edge(bool bf16, int k) {{ return bf16 ? wg::BT : {e}; }}")
    for e in (128, 64)
} | {
    f"sketch_columns{c}": ("sketch_center_gram_project", "sketch_center_gram_project.cu", None,
                           SKETCH_TABLE, f"int sketch_columns(int n) {{ return {c}; }}")
    for c in (112, 128)
}


def build(name: str):
    """The variant's library, built."""
    _, source, header, table, fixed = VARIANTS[name]
    src = (_build.CSRC_DIR / source).read_text()
    if header is not None:
        src = src.replace(f'#include "{header}"', (_build.CSRC_DIR / header).read_text())
    if table not in src:
        raise SystemExit(f"{name}: the table is no longer '{table}'")
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src.replace(table, fixed))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(so))


def use(library: str, lib) -> None:
    """The wrappers load ``lib`` as ``library`` from here on."""
    _build._LOADED[library] = lib
    qr_panel._LIB = None
    matmul._LIB = None
    _occupancy._RESIDENT.clear()


def main() -> None:
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
    x = torch.randn((M, 168), generator=gen, device=dev)
    for n, dtype in ((256, torch.float32), (224, torch.float32), (128, torch.float32),
                     (100, torch.float32), (128, torch.bfloat16)):
        xt = x.to(dtype)
        w = torch.randn((168, n), generator=gen, device=dev).to(dtype)
        row = {"m": M, "t": 168, "n": n, "dtype": str(dtype)[6:]}
        ycs = {}
        for name, lib in (("112", libs["sketch_columns112"]), ("128", libs["sketch_columns128"]),
                          ("table", tables["sketch_center_gram_project"])):
            use("sketch_center_gram_project", lib)
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
