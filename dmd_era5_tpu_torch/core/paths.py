"""Project-root and artifact-path resolution.

The port's copy of ``dmd_era5_tpu/core/paths.py``, with the same
environment variable, so both packages derive the same artifact paths.
The root is resolved once per process by walking up from the
current working directory looking for repo markers, and can be overridden
with the ``DMD_ERA5_TPU_ROOT`` environment variable (which is what tests
use to redirect artifacts into a tmp dir without monkeypatching).
"""

from __future__ import annotations

import os
from pathlib import Path

_ROOT_MARKERS = ("pyproject.toml", ".git", "config.ini")

ROOT_ENV_VAR = "DMD_ERA5_TPU_ROOT"


def repo_root() -> Path:
    """Return the project root directory.

    Resolution order:
      1. ``DMD_ERA5_TPU_ROOT`` environment variable, if set.
      2. Nearest ancestor of the CWD containing a repo marker.
      3. The CWD itself.
    """
    env = os.environ.get(ROOT_ENV_VAR)
    if env:
        return Path(env).expanduser().resolve()
    cwd = Path.cwd().resolve()
    for candidate in (cwd, *cwd.parents):
        if any((candidate / marker).exists() for marker in _ROOT_MARKERS):
            return candidate
    return cwd


def data_dir(stage: str) -> Path:
    """Return (and create) the artifact directory for a pipeline stage."""
    d = repo_root() / "data" / stage
    d.mkdir(parents=True, exist_ok=True)
    return d


def logs_dir() -> Path:
    d = repo_root() / "logs"
    d.mkdir(parents=True, exist_ok=True)
    return d
