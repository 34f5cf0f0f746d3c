"""Content-addressed artifact store with a human-readable version log.

The port's counterpart of ``dmd_era5_tpu/pipeline/artifacts.py``, with
the same layout, so a store written by either package serves the other:
versions live in a local object store (``<root>/store/objects/<md5>``),
each artifact path has a YAML sidecar log (``<path>.yaml``, md5 -> the
config attributes that produced it, append-ordered, each entry stamped
``_store_logged_at`` for ``as_of`` time travel), and retrieval only
copies bytes into the workdir path.  ``DMD_ERA5_TPU_REMOTE`` names a
second object directory that ``add`` pushes to and retrieval falls back
to.  The logs are written and read by ``pipeline/store_log.py``, the
subset of YAML they use, so either package reads the other's logs.
``add_data_to_dvc`` / ``retrieve_data_from_dvc`` are aliases.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.core.paths import repo_root
from dmd_era5_tpu_torch.pipeline import store_log

__all__ = [
    "file_md5",
    "add_data_to_store",
    "retrieve_data_from_store",
    "retrieve_latest_from_store",
    "retrieve_by_md5",
    "list_versions",
    "add_data_to_dvc",
    "retrieve_data_from_dvc",
    "push_to_remote",
    "fetch_from_remote",
]


@functools.cache
def _logger():
    return setup_logger("ArtifactStore-torch", "artifact_store_torch.log")


def _objects_dir() -> Path:
    d = repo_root() / "store" / "objects"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _remote_dir() -> Path | None:
    """The default remote object directory (``DMD_ERA5_TPU_REMOTE``),
    if configured: ``add`` pushes to it and retrieval falls back to it
    when the local cache was wiped."""
    remote = os.environ.get("DMD_ERA5_TPU_REMOTE")
    return Path(remote) if remote else None


def push_to_remote(md5: str) -> bool:
    """Copy one object from the local store to the default remote.

    Returns True if pushed (or already present remotely), False when no
    remote is configured.
    """
    remote = _remote_dir()
    if remote is None:
        return False
    remote.mkdir(parents=True, exist_ok=True)
    dst = remote / md5
    if not dst.exists():
        shutil.copy2(_objects_dir() / md5, dst)
        log_and_print(_logger(), f"Pushed {md5} to remote {remote}")
    return True


def fetch_from_remote(md5: str) -> bool:
    """Restore one object from the default remote into the local store.
    Returns True if the object is now in the local store."""
    remote = _remote_dir()
    if remote is None:
        return False
    src = remote / md5
    if not src.exists():
        return False
    shutil.copy2(src, _objects_dir() / md5)
    log_and_print(_logger(), f"Fetched {md5} from remote {remote}")
    return True


def file_md5(path: str | Path, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


def _log_path(data_path: str | Path) -> Path:
    return Path(str(data_path) + ".yaml")


def _read_log(log_file: Path) -> list:
    """The documents of a version log (each a dict md5 -> attrs, or None)."""
    with open(log_file, encoding="utf-8") as f:
        return store_log.load_all(f.read())


def add_data_to_store(data_path: str | Path, data_attrs: dict) -> str:
    """Version an artifact: copy into the object store and log its attrs.

    Returns the content md5.
    """
    data_path = Path(data_path)
    md5 = file_md5(data_path)
    obj = _objects_dir() / md5
    if not obj.exists():
        shutil.copy2(data_path, obj)

    log_file = _log_path(data_path)

    def _to_yaml(v):
        # attrs re-loaded from HDF5 artifacts come back as numpy
        # arrays/scalars and byte strings — normalize to plain Python
        if isinstance(v, np.ndarray):
            return [_to_yaml(e) for e in v.tolist()]
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, bytes):
            return v.decode()
        if isinstance(v, (list, tuple)):
            return [_to_yaml(e) for e in v]
        return v

    serializable = {k: _to_yaml(v) for k, v in data_attrs.items()}
    # append-time stamp: the handle for as-of time travel
    # (retrieve_data_from_store(..., as_of=...))
    serializable["_store_logged_at"] = (
        datetime.now(timezone.utc).isoformat()
    )
    with open(log_file, "a", encoding="utf-8") as f:
        f.write(store_log.dump({md5: serializable}))
    log_and_print(_logger(), f"Versioned {data_path.name} as {md5}")
    push_to_remote(md5)
    return md5


_SLICE_MATCH_KEYS = ("variables", "levels", "source_path")
_SVD_MATCH_KEYS = (
    "variables",
    "levels",
    "source_path",
    "delay_embedding",
    "mean_center",
    "scale",
    "n_components",
    "forecast_holdout",
)
_DMD_MATCH_KEYS = _SVD_MATCH_KEYS + (
    "dmd_rank",
    "optimized",
    "forecast_steps",
    "bagging_trials",
    "multiresolution_levels",
    "mr_refit_rank",
    "control_input",
)

# Fields added after the store format shipped: entries logged by older
# builds lack them, and a missing key means the entry was produced with
# the default in force.
_MATCH_KEY_DEFAULTS = {
    "forecast_holdout": 0,
    "forecast_steps": 0,
    "bagging_trials": 0,
    "multiresolution_levels": 0,
    "mr_refit_rank": 0,
    "control_input": "none",
}


def _normalize(value):
    if isinstance(value, (list, tuple)):
        return sorted(map(str, value))
    if isinstance(value, bool):
        return int(value)
    return value


def _entry_matches(entry: dict, parsed_config: dict, keys) -> bool:
    for key in keys:
        default = _MATCH_KEY_DEFAULTS.get(key)
        have = entry.get(key, default)
        want = parsed_config.get(key, default)
        if have is None or want is None:
            return False
        if _normalize(have) != _normalize(want):
            return False
    return True


def _entry_visible_as_of(attrs: dict, index: int, as_of) -> bool:
    """Was this log entry already appended "as of" the given point?

    ``as_of`` is an int ordinal (0-based append index into the log —
    every entry, matching or not) or an ISO-8601 timestamp / datetime
    compared against the entry's ``_store_logged_at`` stamp.  Entries
    from logs written before time stamping are treated as older than
    any timestamp (always visible).
    """
    if as_of is None:
        return True
    # bool is an int subclass — True would silently mean "ordinal 1"
    if isinstance(as_of, bool):
        raise TypeError("as_of must be an int ordinal, str, or datetime")
    if isinstance(as_of, int):
        return index <= as_of
    when = (
        datetime.fromisoformat(as_of) if isinstance(as_of, str) else as_of
    )
    stamp = (attrs or {}).get("_store_logged_at")
    if stamp is None:
        return True
    logged = datetime.fromisoformat(stamp)
    # the stored stamp is UTC; a naive as_of is treated as UTC (stripping
    # tzinfo from the stamp instead would shift visibility by the
    # caller's UTC offset)
    if when.tzinfo is None:
        when = when.replace(tzinfo=timezone.utc)
    if logged.tzinfo is None:
        logged = logged.replace(tzinfo=timezone.utc)
    return logged <= when


def retrieve_data_from_store(
    parsed_config: dict, data_type: str = "era5_slice", as_of=None
) -> Path:
    """Find the newest versioned artifact matching the config and place
    it at the workdir path.

    Slices match on variables/levels/source_path; SVD results
    additionally on delay_embedding/mean_center/scale/n_components/
    forecast_holdout.  Raises FileNotFoundError if the log or object is
    missing, ValueError if no entry matches — the error contract the
    stage mains catch.

    ``as_of`` selects the version that was current at a point: an int
    append ordinal or an ISO timestamp/datetime; later log entries are
    invisible to the match.
    """
    if data_type == "era5_slice":
        target = Path(parsed_config["era5_slice_path"])
        keys = _SLICE_MATCH_KEYS
    elif data_type == "era5_svd":
        target = Path(parsed_config["era5_svd_path"])
        keys = _SVD_MATCH_KEYS
    elif data_type == "era5_dmd":
        target = Path(parsed_config["era5_dmd_path"])
        keys = _DMD_MATCH_KEYS
    else:
        raise ValueError(f"Unsupported data_type: {data_type}")

    log_file = _log_path(target)
    if not log_file.exists():
        raise FileNotFoundError(f"No version log found at {log_file}")

    entries = _read_log(log_file)

    best_md5 = None
    index = 0
    for doc in entries:
        if not doc:
            continue
        for md5, attrs in doc.items():
            if _entry_visible_as_of(attrs, index, as_of) and _entry_matches(
                attrs or {}, parsed_config, keys
            ):
                best_md5 = md5  # keep the newest (last) visible match
            index += 1

    if best_md5 is None:
        raise ValueError(
            f"No versioned {data_type} matches the requested configuration"
            + (f" as of {as_of}." if as_of is not None else ".")
        )

    obj = _objects_dir() / best_md5
    if not obj.exists() and not fetch_from_remote(best_md5):
        raise FileNotFoundError(
            f"Object {best_md5} missing from store (log at {log_file})"
        )
    target.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy2(obj, target)
    log_and_print(_logger(), f"Retrieved {data_type} version {best_md5}")
    return target


def _type_keys(data_type: str):
    if data_type == "era5_slice":
        return _SLICE_MATCH_KEYS
    if data_type == "era5_svd":
        return _SVD_MATCH_KEYS
    if data_type == "era5_dmd":
        return _DMD_MATCH_KEYS
    raise ValueError(f"Unsupported data_type: {data_type}")


def list_versions(
    data_path: str | Path, parsed_config: dict | None = None,
    data_type: str = "era5_svd",
) -> list[tuple[str, dict]]:
    """All (md5, attrs) entries logged for an artifact path, in version
    order — optionally filtered to entries matching a config.  Every
    historical version remains addressable, not just the newest match.
    """
    log_file = _log_path(data_path)
    if not log_file.exists():
        return []
    docs = _read_log(log_file)
    out = []
    keys = _type_keys(data_type)
    for doc in docs:
        for md5, attrs in (doc or {}).items():
            if parsed_config is None or _entry_matches(
                attrs or {}, parsed_config, keys
            ):
                out.append((md5, attrs or {}))
    return out


def retrieve_by_md5(md5: str, target: str | Path) -> Path:
    """Place one specific historical version at a workdir path: any
    version is addressable in the object store by its content md5
    (falling back to the remote)."""
    target = Path(target)
    obj = _objects_dir() / md5
    if not obj.exists() and not fetch_from_remote(md5):
        raise FileNotFoundError(f"Object {md5} not in store or remote")
    target.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy2(obj, target)
    log_and_print(_logger(), f"Retrieved version {md5} -> {target}")
    return target


def retrieve_latest_from_store(
    parsed_config: dict, data_type: str = "era5_svd"
) -> Path:
    """Newest store artifact matching the config across ALL version
    logs of the data type — the time window is free.

    ``retrieve_data_from_store`` looks only at the log of the config's
    own derived filename; incremental updates must instead find the
    newest PREFIX-window artifact of the same (source, variables,
    levels, preprocessing), whose filename embeds a different time
    range.  Scans the sibling logs oldest-modified first so the newest
    matching version wins, and places the artifact at the config's own
    workdir path.
    """
    if data_type == "era5_slice":
        target = Path(parsed_config["era5_slice_path"])
    elif data_type == "era5_svd":
        target = Path(parsed_config["era5_svd_path"])
    elif data_type == "era5_dmd":
        target = Path(parsed_config["era5_dmd_path"])
    else:
        raise ValueError(f"Unsupported data_type: {data_type}")
    keys = _type_keys(data_type)

    logs = sorted(
        target.parent.glob("*.yaml"), key=lambda p: p.stat().st_mtime
    )
    best_md5 = None
    for log_file in logs:
        for doc in _read_log(log_file):
            for md5, attrs in (doc or {}).items():
                if _entry_matches(attrs or {}, parsed_config, keys):
                    best_md5 = md5
    if best_md5 is None:
        raise ValueError(
            f"No versioned {data_type} matches the requested configuration."
        )
    return retrieve_by_md5(best_md5, target)


# aliases under the DVC-era names
add_data_to_dvc = add_data_to_store
retrieve_data_from_dvc = retrieve_data_from_store
