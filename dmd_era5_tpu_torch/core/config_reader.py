"""INI configuration reading.

The port's copy of ``dmd_era5_tpu/core/config_reader.py``: a named
section of an INI file is read into a dict whose values are typed via
``ast.literal_eval`` (so ``True`` -> bool, ``2`` -> int, quoted strings ->
str).  A missing section raises; an unparseable value raises.
"""

from __future__ import annotations

import ast
import configparser
from pathlib import Path

from dmd_era5_tpu_torch.core.logging import setup_logger
from dmd_era5_tpu_torch.core.paths import repo_root

logger = setup_logger("ConfigReader", "config_reader.log")


def default_config_path() -> Path:
    """``<root>/config.ini`` — the canonical config location."""
    return repo_root() / "config.ini"


def config_reader(section: str, config_path: str | Path | None = None) -> dict:
    """Read one section of an INI file into a typed dict.

    Args:
        section: Section name, e.g. ``"era5-download"`` or ``"era5-svd"``.
        config_path: Path to the INI file; defaults to ``<root>/config.ini``.

    Returns:
        Dict mapping option names to literal-evaluated Python values.

    Raises:
        Exception: If the section is absent from the file.
        ValueError/SyntaxError: If a value cannot be literal-evaluated.
    """
    path = Path(config_path) if config_path is not None else default_config_path()

    parser = configparser.ConfigParser()
    parser.read(path, encoding="utf-8-sig")

    if not parser.has_section(section):
        msg = f"Section {section} not found in the {path} file"
        logger.error(msg)
        raise Exception(msg)

    out: dict = {}
    for key, raw in parser.items(section):
        try:
            out[key] = ast.literal_eval(raw)
        except Exception as err:
            msg = (
                f"Error while parsing {key} from {section} section "
                f"in the config file: {err}"
            )
            logger.error(msg)
            print(msg)
            raise
    return out
