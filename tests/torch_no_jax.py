"""A command line that runs Python code with JAX, h5py and yaml hidden
(``sys.modules[name] = None``, so that importing any of them raises: the
card's machine has none of them) and fails afterwards if any module of
the JAX package ``dmd_era5_tpu`` was loaded, even where the code exits
with ``sys.exit``.  The port's tools, examples and stage mains run
through it in their subprocess tests, so such an import anywhere on their
path, inside a function too, fails the test."""

from __future__ import annotations

import sys
import textwrap

HIDDEN = ("jax", "h5py", "yaml")


def python_without_jax(code: str) -> list[str]:
    """``[python, "-c", ...]`` running ``code`` as described above."""
    body = textwrap.indent(textwrap.dedent(code).strip(), "    ")
    return [sys.executable, "-c", (
        "import sys\n"
        f"for name in {HIDDEN!r}: sys.modules[name] = None\n"
        "try:\n"
        f"{body}\n"
        "finally:\n"
        "    loaded = sorted(m for m in sys.modules\n"
        "                    if m == 'dmd_era5_tpu' or m.startswith('dmd_era5_tpu.'))\n"
        "    assert not loaded, f'the JAX package was imported: {loaded}'\n")]


def script_without_jax(path: str, *args: str) -> list[str]:
    """The command line that runs the script at ``path`` as ``__main__``
    with ``args``, as :func:`python_without_jax` runs code."""
    return python_without_jax(
        f"import runpy\n"
        f"sys.argv = [{path!r}, *{list(args)!r}]\n"
        f"runpy.run_path({path!r}, run_name='__main__')\n")
