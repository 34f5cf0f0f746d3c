"""Guards of the port's boundaries: no JAX, no hidden CPU path, no
silent fallback from the kernel."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dmd_era5_tpu_torch.ops import matmul

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "dmd_era5_tpu_torch"


def test_package_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import dmd_era5_tpu_torch, dmd_era5_tpu_torch.convert\n"
        "import dmd_era5_tpu_torch.ops, dmd_era5_tpu_torch.models\n"
        "import dmd_era5_tpu_torch.pipeline, dmd_era5_tpu_torch.snapmat\n"
        "import dmd_era5_tpu_torch.utils\n"
        "assert not any(m == 'dmd_era5_tpu' or m.startswith('dmd_era5_tpu.')"
        " for m in sys.modules), 'the JAX package was imported'\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", ["dmd_era5_tpu_torch", "chip_smoke.py"])
def test_no_jax_import_lines(path):
    files = [ROOT / path] if path.endswith(".py") else sorted((ROOT / path).rglob("*.py"))
    pattern = re.compile(r"^\s*(import jax|from jax|import dmd_era5_tpu\b(?!_torch)"
                         r"|from dmd_era5_tpu\b(?!_torch))", re.M)
    hits = [f"{f.relative_to(ROOT)}" for f in files if pattern.search(f.read_text())]
    assert not hits


def test_chip_smoke_fails_without_cuda(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    before = matmul.sketch_center_gram_project.launches
    x = torch.randn(70, 12, generator=torch.Generator().manual_seed(0))
    w = torch.randn(12, 8, generator=torch.Generator().manual_seed(1))
    out = matmul.sketch_center_gram_project(x, w, scalar_stats=True)
    ref = matmul._sketch_center_gram_project_plain(x, w, scalar_stats=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert matmul.sketch_center_gram_project.launches == before == 0


def test_kernel_range_and_devices_raise():
    x = torch.zeros(10, 12)
    with pytest.raises(ValueError, match="K2 sketch_center_gram"):
        matmul.sketch_center_gram_project(x, torch.zeros(12, matmul.N_MAX + 1))
    with pytest.raises(ValueError, match="no kernel for device"):
        matmul.sketch_center_gram_project(x.to("meta"), torch.zeros(12, 4, device="meta"))
    with pytest.raises(ValueError, match="share one dtype"):
        matmul.sketch_center_gram_project(x, torch.zeros(12, 4, dtype=torch.bfloat16))
