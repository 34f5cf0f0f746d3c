"""``scripts/torch_verify.py``: its fifteen oracle checks pass on the host,
and its numpy copy of scikit-learn's ``randomized_svd`` is sklearn's."""

from __future__ import annotations

import importlib.util
import subprocess
from pathlib import Path

import numpy as np
from torch_no_jax import script_without_jax

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "torch_verify.py"


def _script():
    spec = importlib.util.spec_from_file_location("torch_verify", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_oracle_checks_pass_on_the_host_and_kernel_checks_are_not_run():
    """With JAX hidden, and nothing of the JAX package loaded by the run's
    end (``torch_no_jax``)."""
    proc = subprocess.run(script_without_jax(str(SCRIPT), "--device", "cpu"), cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert sum(line.startswith("PASS  ") for line in lines) == 15
    assert not any(line.startswith("FAIL") for line in lines)
    assert "15/15 checks passed" in lines
    assert "7 kernel checks not run: they need a CUDA card" in lines


def test_randomized_svd_copy_is_sklearns():
    """At tpu_verify's input (default_rng(0), 4096 x 96, k 12): s to 1e-6
    relative, U and V to 1e-5 up to a sign a component."""
    from sklearn.utils.extmath import randomized_svd

    rng = np.random.default_rng(0)
    a = rng.standard_normal((4096, 16))
    b = rng.standard_normal((16, 96))
    x = ((a * np.logspace(0, -2, 16)) @ b + 1e-4 * rng.standard_normal((4096, 96))
         ).astype(np.float32)
    u, s, v = _script().randomized_svd_np(x, 12, random_state=0)
    u_sk, s_sk, v_sk = randomized_svd(x, n_components=12, random_state=0)
    assert u.shape == u_sk.shape and v.shape == v_sk.shape
    np.testing.assert_allclose(s, s_sk, rtol=1e-6)
    signs = np.sign(np.sum(u * u_sk, axis=0))
    np.testing.assert_allclose(u * signs, u_sk, rtol=0, atol=1e-5)
    np.testing.assert_allclose(v * signs[:, None], v_sk, rtol=0, atol=1e-5)
    # a wide matrix goes through sklearn's transpose and v-based flip
    u, s, v = _script().randomized_svd_np(x[:40].copy(), 5, random_state=3)
    u_sk, s_sk, v_sk = randomized_svd(x[:40].copy(), n_components=5, random_state=3)
    np.testing.assert_allclose(s, s_sk, rtol=1e-6)
    signs = np.sign(np.sum(u * u_sk, axis=0))
    np.testing.assert_allclose(u * signs, u_sk, rtol=0, atol=1e-5)


def test_dmdc_eigenvalues_are_matched_not_sorted():
    """tpu_verify compares DMDc's eigenvalues in ``np.sort_complex`` order,
    which orders a conjugate pair by the rounding of its real parts (R1's
    fault): a pair found to 1e-7 reads 2 |Im| off when its real parts
    round the other way.  The script matches them one to one instead."""
    true = np.array([0.4 + 0.8j, 0.4 - 0.8j, 0.9 + 0.3j, 0.9 - 0.3j])
    found = true + np.array([-1e-7, 1e-7, 0, 0])  # the upper one's real part rounded down
    sorted_err = np.abs(np.sort_complex(found) - np.sort_complex(true)).max()
    assert abs(sorted_err - 1.6) < 1e-6
    assert _script().matched_error(found, true) <= 2e-7
