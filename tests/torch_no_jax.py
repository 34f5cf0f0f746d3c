"""A command line that runs Python code with JAX hidden (``sys.modules['jax']
= None``, so that any ``import jax`` raises) and fails afterwards if any
module of the JAX package ``dmd_era5_tpu`` was loaded, even where the code
exits with ``sys.exit``.  The port's tools and examples run through it in
their subprocess tests, so a JAX import anywhere on their path, inside a
function too, fails the test."""

from __future__ import annotations

import sys
import textwrap


def python_without_jax(code: str) -> list[str]:
    """``[python, "-c", ...]`` running ``code`` as described above."""
    body = textwrap.indent(textwrap.dedent(code).strip(), "    ")
    return [sys.executable, "-c", (
        "import sys\n"
        "sys.modules['jax'] = None\n"
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
