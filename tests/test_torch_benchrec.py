"""The port's bench record against the JAX package's: test_28's merge-by-
metric contract, each case fed to both packages' merge, with equal lists
and equal files expected.  (test_28's source guard on the JAX bench
scripts has no counterpart yet: the port has no bench script.)"""

from __future__ import annotations

import json

import pytest

from dmd_era5_tpu.utils import benchrec as jb
from dmd_era5_tpu_torch.utils import benchrec as tb

FIRST = [{"metric": "scale_week", "value": 1.0, "unit": "x"},
         {"metric": "scale_month", "value": 2.0, "unit": "x"}]


def _both_files(tmp_path, *batches):
    """Each batch merged in turn into a fresh record by each package;
    the two records' texts."""
    texts = []
    for name, module in (("jax", jb), ("torch", tb)):
        rec = tmp_path / name / "BENCH_EXTENDED.json"
        rec.parent.mkdir()
        for batch in batches:
            module.merge_into_bench_record(rec, batch)
        texts.append(rec.read_text())
    return texts


def test_merge_preserves_foreign_metrics(tmp_path):
    text_j, text_t = _both_files(
        tmp_path, FIRST, [{"metric": "classic_tsqr", "value": 9.0, "unit": "x"}])
    assert text_t == text_j
    assert {e["metric"] for e in json.loads(text_t)} == {"scale_week", "scale_month",
                                                        "classic_tsqr"}


@pytest.mark.parametrize("new", [
    [{"metric": "b", "value": 20, "extra": "new"}],
    [{"metric": "d", "value": 4}, {"metric": "a", "value": 10}],
    [{"metric": "b", "value": 5}, {"metric": "b", "value": 6, "_work": [1]}],
])
def test_merge_replaces_same_metric_in_place(new):
    existing = [{"metric": "a", "value": 1}, {"metric": "b", "value": 2},
                {"metric": "c", "value": 3}]
    got = tb.merge_bench_entries(existing, new)
    assert got == jb.merge_bench_entries(existing, new)
    assert [e["metric"] for e in got][:3] == ["a", "b", "c"]
    assert existing[1] == {"metric": "b", "value": 2}  # the input is not modified


def test_merge_strips_working_fields(tmp_path):
    text_j, text_t = _both_files(tmp_path, [{"metric": "m", "value": 1, "_s_full": [1, 2, 3]}])
    assert text_t == text_j
    assert json.loads(text_t) == [{"metric": "m", "value": 1}]


def test_merge_from_missing_file(tmp_path):
    text_j, text_t = _both_files(tmp_path, [{"metric": "m", "value": 1}])
    assert text_t == text_j
    assert json.loads(text_t) == [{"metric": "m", "value": 1}]
