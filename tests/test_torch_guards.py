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
from torch_no_jax import python_without_jax

from dmd_era5_tpu_torch.ops import matmul, qr_panel
from dmd_era5_tpu_torch.ops.tsqr import _local_factor, in_householder_kernel_envelope, qr_positive
from dmd_era5_tpu_torch.pipeline import (
    streamed_exact_gram_svd,
    streamed_onepass_svd,
    streamed_randomized_svd,
)

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "dmd_era5_tpu_torch"


def test_package_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import dmd_era5_tpu_torch, dmd_era5_tpu_torch.convert\n"
        "import dmd_era5_tpu_torch.ops, dmd_era5_tpu_torch.models\n"
        "import dmd_era5_tpu_torch.pipeline, dmd_era5_tpu_torch.snapmat\n"
        "import dmd_era5_tpu_torch.utils, dmd_era5_tpu_torch.core\n"
        "import dmd_era5_tpu_torch.pipeline.era5_svd, dmd_era5_tpu_torch.utils.labels\n"
        + _NEW_MODULES +
        "assert not any(m == 'dmd_era5_tpu' or m.startswith('dmd_era5_tpu.')"
        " for m in sys.modules), 'the JAX package was imported'\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


_NEW_MODULES = (
    "import dmd_era5_tpu_torch.snapmat.mock, dmd_era5_tpu_torch.snapmat.slicing\n"
    "import dmd_era5_tpu_torch.utils.io_h5, dmd_era5_tpu_torch.pipeline.artifacts\n"
    "import dmd_era5_tpu_torch.pipeline.era5_download\n"
    "import dmd_era5_tpu_torch.models.dmdc, dmd_era5_tpu_torch.models.mrdmd\n"
    "import dmd_era5_tpu_torch.models.analysis, dmd_era5_tpu_torch.pipeline.ensemble\n"
    "import dmd_era5_tpu_torch.utils.checkpoint\n"
    "import dmd_era5_tpu_torch.ops.onepass, dmd_era5_tpu_torch.ops.streaming\n"
    "import dmd_era5_tpu_torch.pipeline.incremental, dmd_era5_tpu_torch.pipeline.era5_svd_update\n"
    "import dmd_era5_tpu_torch.utils.profiling, dmd_era5_tpu_torch.utils.debug\n"
    "import dmd_era5_tpu_torch.snapmat.zarr_reader, dmd_era5_tpu_torch.snapmat.era5_zarr\n"
    "import dmd_era5_tpu_torch.native, dmd_era5_tpu_torch.snapmat.loader\n"
    "import dmd_era5_tpu_torch.parallel, dmd_era5_tpu_torch.parallel.collectives\n"
    "assert 'fsspec' not in sys.modules, 'fsspec imported with the port'\n"
)


def test_package_imports_without_h5py_yaml_or_pandas(tmp_path):
    """The port needs neither h5py nor yaml (the card's machine has
    neither) nor pandas: with all three hidden, the whole port imports,
    and each of its files is written and read back by its own codecs:
    a FieldSet, a checkpoint, a packed HDF5 matrix, a store's log."""
    code = (
        "import sys\n"
        "for name in ('jax', 'h5py', 'yaml', 'pandas'): sys.modules[name] = None\n"
        "import dmd_era5_tpu_torch, dmd_era5_tpu_torch.convert\n"
        "import dmd_era5_tpu_torch.ops, dmd_era5_tpu_torch.models, dmd_era5_tpu_torch.core\n"
        "import dmd_era5_tpu_torch.pipeline, dmd_era5_tpu_torch.snapmat, dmd_era5_tpu_torch.utils\n"
        + _NEW_MODULES +
        "import dmd_era5_tpu_torch.utils.hdf5, dmd_era5_tpu_torch.pipeline.store_log\n"
        "from dmd_era5_tpu_torch.snapmat import create_mock_era5, resample_era5_dataset\n"
        "import datetime\n"
        "fs = create_mock_era5('2020-01-01', '2020-01-01T05', ['temperature'], [1000], seed=0)\n"
        "assert resample_era5_dataset(fs, datetime.timedelta(hours=2)).sizes['time'] == 3\n"
        "import os, numpy as np, torch\n"
        f"os.environ['DMD_ERA5_TPU_ROOT'] = {str(tmp_path)!r}\n"
        "os.environ.pop('DMD_ERA5_TPU_REMOTE', None)\n"
        f"d = {str(tmp_path)!r}\n"
        "from dmd_era5_tpu_torch.utils.io_h5 import save_fieldset, load_fieldset\n"
        "save_fieldset(fs, d + '/fs.h5')\n"
        "back = load_fieldset(d + '/fs.h5')\n"
        "assert np.array_equal(back['temperature'].values, fs['temperature'].values)\n"
        "from dmd_era5_tpu_torch.utils.checkpoint import save_pytree, load_pytree\n"
        "save_pytree(d + '/ck.h5', {'a': torch.arange(3)}, metadata={'iteration': 2})\n"
        "leaves, meta = load_pytree(d + '/ck.h5')\n"
        "assert meta == {'iteration': 2} and leaves[0].tolist() == [0, 1, 2]\n"
        "from dmd_era5_tpu_torch.snapmat import loader\n"
        "x = np.arange(60, dtype=np.float32).reshape(12, 5)\n"
        "assert loader.save_packed_matrix(d + '/x.h5', x) == (12, 5)\n"
        "assert loader.read_packed_rows(d + '/x.h5', 2, 7).tobytes() == x[2:7].tobytes()\n"
        "from dmd_era5_tpu_torch.pipeline import artifacts\n"
        "md5 = artifacts.add_data_to_store(d + '/fs.h5', back.attrs)\n"
        "assert [m for m, _ in artifacts.list_versions(d + '/fs.h5')] == [md5]\n"
        "assert not any(m in sys.modules and sys.modules[m] for m in ('h5py', 'yaml'))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def _port_files() -> list[Path]:
    """The port's sources: the package, the smoke, its scripts and
    examples (``torch_*``), the quickstart notebook."""
    files = sorted((ROOT / "dmd_era5_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    files += sorted((ROOT / "scripts").glob("torch_*.py"))
    files += sorted((ROOT / "examples").glob("torch_*"))
    return files


def test_no_h5py_or_yaml_import_lines():
    """No import of h5py or yaml, anywhere in the port's sources (inside
    functions too), its smoke, scripts, examples and notebook."""
    pattern = re.compile(r"(?:^|[\s;\"'])(?:import|from)\s+(?:h5py|yaml)\b"
                         r"|import_module\(\s*[\"'](?:h5py|yaml)", re.M)
    files = _port_files()
    assert any(f.suffix == ".ipynb" for f in files) and len(files) > 60
    hits = [f"{f.relative_to(ROOT)}" for f in files if pattern.search(f.read_text())]
    assert not hits


def test_config1_stage_mains_run_without_h5py_or_yaml(tmp_path):
    """North-star config 1 (config.ini on the mock) through
    era5_download.main -> era5_svd.main -> era5_dmd.main with the store,
    then each stage's cache hit, with h5py, yaml and JAX hidden."""
    code = f"""
import os
os.environ["DMD_ERA5_TPU_ROOT"] = {str(tmp_path / "root")!r}
os.environ["DMD_ERA5_TPU_REMOTE"] = {str(tmp_path / "remote")!r}
import numpy as np
from dmd_era5_tpu_torch.core import config_parser, config_reader
from dmd_era5_tpu_torch.pipeline import era5_dmd, era5_download, era5_svd
from dmd_era5_tpu_torch.pipeline.artifacts import file_md5, list_versions

np.random.seed(0)
ini = {str(ROOT / "config.ini")!r}
assert era5_download.main(config_reader("era5-download", ini), use_mock_data=True,
                          use_store=True) == (True, False)
svd_cfg = {{**config_reader("era5-svd", ini), "source_path": "mock_data"}}
svd, added, retrieved = era5_svd.main(dict(svd_cfg), write_artifact=True, use_store=True,
                                      device="cpu")
assert added and not retrieved and svd["U"].shape == (2 * 36 * 72, 10)
hit, added, retrieved = era5_svd.main(dict(svd_cfg), write_artifact=True, use_store=True,
                                      device="cpu")
assert not added and not retrieved
assert np.array_equal(hit["U"].values, svd["U"].values)
dmd_cfg = {{**config_reader("era5-dmd", ini), "source_path": "mock_data"}}
res, added, retrieved = era5_dmd.main(dict(dmd_cfg), write_artifact=True, use_store=True,
                                      device="cpu")
assert added and not retrieved
again, added, retrieved = era5_dmd.main(dict(dmd_cfg), write_artifact=True, use_store=True,
                                        device="cpu")
assert not added and not retrieved
assert np.array_equal(again["eigenvalues"].values, res["eigenvalues"].values)
parsed = config_parser(dict(dmd_cfg), "era5-dmd")
logged = [m for m, _ in list_versions(parsed["era5_dmd_path"], data_type="era5_dmd")]
assert logged == [file_md5(parsed["era5_dmd_path"])]
assert os.listdir({str(tmp_path / "remote")!r})
"""
    proc = subprocess.run(python_without_jax(code), cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_checkpointed_lm_resumes_without_h5py_or_yaml(tmp_path):
    """``varpro_lm_checkpointed`` capped early leaves its HDF5 checkpoint
    and resumes from it, with h5py, yaml and JAX hidden."""
    code = f"""
import numpy as np
import torch
from dmd_era5_tpu_torch.models.optdmd import varpro_lm_checkpointed
from dmd_era5_tpu_torch.utils.checkpoint import load_pytree

rng = np.random.default_rng(0)
alpha_true = np.array([-0.1 + 1.5j, -0.1 - 1.5j], dtype=np.complex64)
t = np.arange(48, dtype=np.float32) * 0.1
b = (rng.standard_normal((2, 6)) + 1j * rng.standard_normal((2, 6))).astype(np.complex64)
h = (np.exp(np.outer(t, alpha_true)) @ b).astype(np.complex64)
alpha0 = (alpha_true * 1.05 + 0.02j).astype(np.complex64)
h, t, alpha0 = torch.from_numpy(h), torch.from_numpy(t), torch.from_numpy(alpha0)
path = {str(tmp_path / "lm.h5")!r}
varpro_lm_checkpointed(h, t, alpha0, path, max_iter=4, chunk_iters=2)
_, meta = load_pytree(path)
assert meta["iteration"] >= 1
alpha, _, rel, n = varpro_lm_checkpointed(h, t, alpha0, path, max_iter=40, chunk_iters=10)
assert n >= meta["iteration"]
found = sorted(alpha.numpy().tolist(), key=lambda z: z.imag)
assert np.allclose(found, sorted(alpha_true.tolist(), key=lambda z: z.imag), atol=5e-3), found
"""
    proc = subprocess.run(python_without_jax(code), cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_stage_main_needs_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    """``era5_svd.main`` without ``device`` computes on the card: without
    CUDA it raises instead of running on the host."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.pipeline import era5_download, era5_svd
    from dmd_era5_tpu_torch.snapmat import create_mock_era5
    from dmd_era5_tpu_torch.utils.io_h5 import save_fieldset

    monkeypatch.setenv("DMD_ERA5_TPU_ROOT", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"source_path": "mock_data", "start_datetime": "2019-01-01T00",
           "end_datetime": "2019-01-01T12", "delta_time": "1h", "variables": "temperature",
           "levels": "1000", "svd_type": "randomized", "delay_embedding": 2, "mean_center": True,
           "scale": False, "n_components": 3, "save_data_matrix": False}
    parsed = config_parser(dict(cfg), "era5-svd")
    fs = create_mock_era5("2019-01-01T00", "2019-01-01T12", ["temperature"], [1000], seed=1)
    save_fieldset(era5_download.add_config_attributes(fs, parsed), parsed["era5_slice_path"])
    with pytest.raises(Exception, match="CUDA card"):
        era5_svd.main(dict(cfg))
    assert era5_svd.main(dict(cfg), device="cpu")[0]["U"].shape == (2 * 36 * 72, 3)


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
    # a sketch wider than K1 takes the two-pass route (K2 then K3), on the
    # CPU through their plain versions; K2's own range raises past it
    wide = torch.zeros(12, matmul.N_MAX + 1)
    assert matmul.takes_two_pass(12, matmul.N_MAX + 1, 4)
    yc, _, _, g, c = matmul.sketch_center_gram_project(x, wide)
    assert yc.shape == (10, matmul.N_MAX + 1) and g.shape == (matmul.N_MAX + 1,) * 2
    assert c.shape == (matmul.N_MAX + 1, 12)
    assert matmul.sketch_center_gram.launches == matmul.project.launches == 0
    with pytest.raises(ValueError, match="sketch_center_gram kernel"):
        matmul.sketch_center_gram_project(x, torch.zeros(12, matmul.SKETCH_N_MAX + 1))
    with pytest.raises(ValueError, match="no kernel for device"):
        matmul.sketch_center_gram_project(x.to("meta"), torch.zeros(12, 4, device="meta"))
    with pytest.raises(ValueError, match="share one dtype"):
        matmul.sketch_center_gram_project(x, torch.zeros(12, 4, dtype=torch.bfloat16))


@pytest.mark.parametrize("precision", qr_panel.PRECISIONS)
def test_cpu_gram_takes_plain_version_and_counts_no_launch(precision):
    a = torch.randn(130, 20, generator=torch.Generator().manual_seed(2))
    before = dict(qr_panel.gram.launches)
    assert torch.equal(qr_panel.gram(a, precision), qr_panel._gram_plain(a, precision))
    assert qr_panel.gram.launches == before == {p: 0 for p in qr_panel.PRECISIONS}


def test_gram_range_and_devices_raise():
    a = torch.zeros(10, 12)
    # no range limit: wider than the JAX kernel's K <= 1024 is taken
    assert qr_panel.gram(torch.zeros(4, 1030)).shape == (1030, 1030)
    with pytest.raises(ValueError, match="no kernel for device"):
        qr_panel.gram(a.to("meta"))
    with pytest.raises(ValueError, match="precision must be one of"):
        qr_panel.gram(a, "high")
    with pytest.raises(ValueError, match="takes a of dtype"):
        qr_panel.gram(a.to(torch.bfloat16), "bf16_split")
    with pytest.raises(ValueError, match="non-empty"):
        qr_panel.gram(torch.zeros(0, 12))


def test_householder_leaf_raises_inside_k7_envelope_off_cpu():
    """The JAX package runs its Householder panel kernel (K7) on the
    accelerator inside a 12 MiB envelope and the library QR outside it;
    the port's leaf does the same off the CPU, so a tensor on a device
    with no kernel reaches the kernel wrapper there and is refused."""
    assert in_householder_kernel_envelope(16_384, 64)
    assert not in_householder_kernel_envelope(16_384, 257)
    assert not in_householder_kernel_envelope(15_573_600, 110)
    with pytest.raises(ValueError, match="no kernel for device"):
        _local_factor(torch.zeros(1000, 32, device="meta"), "householder")
    with pytest.raises(ValueError, match="qr method must be one of"):
        _local_factor(torch.zeros(10, 4), "xla")


def test_cpu_matmul_and_householder_take_plain_versions():
    gen = torch.Generator().manual_seed(3)
    x, w = torch.randn(70, 12, generator=gen), torch.randn(12, 9, generator=gen)
    assert torch.equal(matmul.matmul(x, w), matmul._matmul_plain(x, w, torch.float32))
    q, r = qr_panel.householder_panel(x)
    q_p, r_p = qr_panel._householder_plain(x)
    signs = torch.where(torch.diagonal(r_p) < 0, -1.0, 1.0)
    assert torch.equal(q, q_p * signs) and torch.equal(r, r_p * signs[:, None])
    # the CPU leaf stays the library QR, as the JAX package's does
    assert torch.equal(_local_factor(x, "householder")[1], qr_positive(x)[1])
    assert matmul.matmul.launches == qr_panel.householder_panel.launches == 0
    with pytest.raises(ValueError, match="no kernel for device"):
        matmul.matmul(x.to("meta"), w.to("meta"))


def test_streamed_svd_needs_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    """``device=None`` is the card: without CUDA the streamed entry
    points raise instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(4)).numpy()
    for entry in (streamed_randomized_svd, streamed_exact_gram_svd, streamed_onepass_svd):
        with pytest.raises(RuntimeError, match="CUDA card"):
            entry(x, 3)
        assert entry(x, 3, block_rows=16, device="cpu").U.shape == (64, 3)


def test_dmd_models_need_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    """The DMD models' entry points on host data compute on the card:
    without CUDA they raise instead of running on the host; told the CPU
    (or given CPU tensors) they take the kernels' plain versions there and
    count no launch."""
    import numpy as np

    from dmd_era5_tpu_torch.models import fit_dmdc, fit_mrdmd, fit_mrdmd_streamed
    from dmd_era5_tpu_torch.pipeline import fit_per_variable_level
    from dmd_era5_tpu_torch.snapmat import create_mock_era5

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40, 32)).astype(np.float32)
    u = rng.standard_normal((1, 31)).astype(np.float32)
    path = tmp_path / "x.npy"
    np.save(path, x)
    fs = create_mock_era5("2020-01-01", "2020-01-01T05", ["temperature"], [1000], seed=0)
    calls = {
        "fit_dmdc": lambda **kw: fit_dmdc(x, u, rank=3, **kw),
        "fit_mrdmd": lambda **kw: fit_mrdmd(x, rank=3, max_levels=2, **kw),
        "fit_mrdmd_streamed": lambda **kw: fit_mrdmd_streamed(path, rank=3, max_levels=2, **kw),
        "fit_per_variable_level": lambda **kw: fit_per_variable_level(fs, 2, **kw),
    }
    before = dict(qr_panel.gram.launches), matmul.sketch_center_gram_project.launches
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()
        assert call(device="cpu") is not None, name
    assert fit_mrdmd(torch.from_numpy(x), rank=3, max_levels=2).residual.device.type == "cpu"
    assert (dict(qr_panel.gram.launches), matmul.sketch_center_gram_project.launches) == before


def test_carried_state_and_forecast_times_need_a_card_unless_told_otherwise(monkeypatch):
    """``convert``'s functions and ``forecast_times`` place their tensors
    on the card unless ``device`` is given: without CUDA they raise."""
    import numpy as np

    from dmd_era5_tpu_torch import convert
    from dmd_era5_tpu_torch.models import forecast_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u, s, v = np.ones((6, 2), np.float32), np.ones(2, np.float32), np.ones((2, 5), np.float32)
    with pytest.raises(RuntimeError, match="CUDA card"):
        convert.svd_result_from_numpy(u, s, v)
    with pytest.raises(RuntimeError, match="CUDA card"):
        convert.mrdmd_result_from_numpy([], None, 1.0, 5)
    with pytest.raises(RuntimeError, match="CUDA card"):
        forecast_times(5, 3, 1.0)
    assert convert.svd_result_from_numpy(u, s, v, device="cpu").U.device.type == "cpu"
    assert forecast_times(5, 3, 0.5, device="cpu").tolist() == [0.5 * i for i in range(8)]


TOOLS = ["scripts/torch_verify.py", "examples/torch_demo_pipeline.py",
         "examples/torch_demo_out_of_core.py"]


@pytest.mark.parametrize("path", TOOLS)
def test_tools_import_neither_jax_nor_the_jax_package(path):
    """The verify script and the examples load with JAX hidden and bring in
    nothing of ``dmd_era5_tpu``; the notebook's cells import only the port."""
    code = (
        "import sys, runpy; sys.modules['jax'] = None\n"
        f"runpy.run_path({str(ROOT / path)!r}, run_name='not_main')\n"
        "assert not any(m == 'dmd_era5_tpu' or m.startswith('dmd_era5_tpu.')"
        " for m in sys.modules), 'the JAX package was imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_notebook_imports_only_the_port():
    import json

    nb = json.loads((ROOT / "examples" / "torch_quickstart.ipynb").read_text())
    src = "\n".join("".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code")
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert imports and all(m.split(".")[0] in ("dmd_era5_tpu_torch", "numpy") for m in imports)


# Public top-level names of the JAX package with no counterpart in the
# port, each for its reason
NOT_PORTED = {
    "native_available": "the C++ packer's build probe: the port packs in torch on the host "
                        "(dmd_era5_tpu_torch/native), with nothing to build",
    "pallas_ok": "probes whether Pallas lowers on the TPU backend; the port's kernels are "
                 "CUDA C++ built by nvcc, chosen by the tensor's device",
    "enable_float64": "switches JAX's x64 mode; torch has f64 tensors without a switch",
    "eig_host": "the TPU's host callback for a general eigensolver; the port's eig_sorted "
                "runs torch.linalg.eig on the device",
    "tri_inv": "the TPU's iteratively refined triangular inverse; the port solves with "
               "torch.linalg.solve_triangular in row blocks",
}


def _public_top_level_names(package: Path) -> dict:
    """Every public function and class defined at the top level of a
    module of ``package``, by name, read from the source (not imported)."""
    import ast

    names: dict = {}
    for path in sorted(package.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                    and not node.name.startswith("_"):
                names.setdefault(node.name, []).append(str(path.relative_to(ROOT)))
    return names


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    jax_names = _public_top_level_names(ROOT / "dmd_era5_tpu")
    port_names = _public_top_level_names(PACKAGE)
    missing = {name: where for name, where in jax_names.items()
               if name not in port_names and name not in NOT_PORTED}
    assert not missing
    assert set(NOT_PORTED) <= set(jax_names)  # no stale exclusion
    assert not set(NOT_PORTED) & set(port_names)
