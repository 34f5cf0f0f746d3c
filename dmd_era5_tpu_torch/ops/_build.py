"""Build and load the hand-written CUDA kernels of this package.

Each kernel source under ``ops/csrc/`` exposes a plain C interface and
is compiled by ``nvcc`` into its own shared library at first use, then
loaded with ``ctypes``.  Libraries land in ``build/dmd_era5_tpu_torch/``
at the repository root, named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one loads in milliseconds.
Nothing here runs at import time: the CPU-only test environment has no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_kernel_library", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dmd_era5_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "dmd_era5_tpu_torch are built from source at first use"
    )


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per source hash) and load it."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = BUILD_DIR / f"{name}_{digest}.log"
        log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                + proc.stderr[-4000:]
            )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = lib
    return lib
