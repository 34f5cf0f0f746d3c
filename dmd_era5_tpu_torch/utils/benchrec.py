"""Append-only benchmark record: merge-by-metric JSON writer.

The port's copy of ``dmd_era5_tpu/utils/benchrec.py``.  Every benchmark
script writes a subset of the metrics of one shared record, so the
writer merges by metric name rather than rewriting the file wholesale:
a wholesale ``json.dump`` from one script would delete every entry
another script owns.

Entries whose keys start with ``_`` are working fields (full singular
values, open handles) and are stripped before writing.
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = ["merge_bench_entries", "merge_into_bench_record"]


def merge_bench_entries(existing: list[dict], new: list[dict]) -> list[dict]:
    """Merge ``new`` entries into ``existing`` keyed by ``metric``.

    Preserves the order of ``existing``; new metrics append at the end;
    an entry with a metric already present replaces it in place.
    """
    by_metric = {e["metric"]: dict(e) for e in existing}
    order = [e["metric"] for e in existing]
    for e in new:
        e = {k: v for k, v in e.items() if not k.startswith("_")}
        if e["metric"] not in by_metric:
            order.append(e["metric"])
        by_metric[e["metric"]] = e
    return [by_metric[m] for m in order]


def merge_into_bench_record(path: str | Path, entries: list[dict]) -> None:
    """Merge ``entries`` into the JSON record at ``path`` (by metric); a
    missing file starts empty."""
    path = Path(path)
    existing = json.loads(path.read_text()) if path.exists() else []
    path.write_text(json.dumps(merge_bench_entries(existing, entries), indent=1))
