"""The port's examples run end to end (tests/test_22_examples.py's three
cases on ``examples/torch_*``).

Each runs in a subprocess with ``--device cpu`` (the notebook: its one
``DEVICE`` assignment set to "cpu") and a fresh ``DMD_ERA5_TPU_ROOT``,
so a drifting example is a test failure; the artifacts land in that
root's store.  JAX is hidden in the subprocess, and the run fails if
anything of the JAX package was loaded by its end (``torch_no_jax``).
"""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path

from torch_no_jax import python_without_jax, script_without_jax

REPO = Path(__file__).resolve().parent.parent


def _run(command: list[str], root: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, DMD_ERA5_TPU_ROOT=str(root))
    proc = subprocess.run(command, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def test_torch_demo_pipeline_script_runs(tmp_path):
    proc = _run(script_without_jax("examples/torch_demo_pipeline.py", "--device", "cpu"),
                tmp_path)
    assert "continuous eigenvalues" in proc.stdout
    assert "DMD residual" in proc.stdout
    assert "forecast field" in proc.stdout
    assert "on cpu" in proc.stdout
    # the run must have versioned artifacts into the hermetic store
    assert any((tmp_path / "store" / "objects").iterdir())


def test_torch_quickstart_notebook_executes(tmp_path):
    """Every code cell of the notebook exec'd in order in one namespace,
    the first cell's ``DEVICE`` set to the host."""
    nb = json.loads((REPO / "examples" / "torch_quickstart.ipynb").read_text())
    cells = ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]
    assert len(cells) >= 4
    assert cells[0].count("DEVICE = None") == 1
    cells[0] = cells[0].replace("DEVICE = None", 'DEVICE = "cpu"')
    # cell 1 reads <root>/config.ini; artifacts land in the tmp root
    (tmp_path / "config.ini").write_text((REPO / "config.ini").read_text())
    source = "\n\n".join(cells)
    proc = _run(python_without_jax(f"exec(compile({source!r}, 'torch_quickstart', 'exec'), "
                                   "{'__name__': '__main__'})"), tmp_path)
    assert "singular values:" in proc.stdout
    assert "alpha =" in proc.stdout
    assert any((tmp_path / "store" / "objects").iterdir())


def test_torch_demo_out_of_core_script_runs(tmp_path):
    proc = _run(script_without_jax("examples/torch_demo_out_of_core.py", "--device", "cpu"),
                tmp_path)
    assert "out-of-core factors agree with dense numpy." in proc.stdout
