"""The store log's YAML subset (``dmd_era5_tpu_torch/pipeline/store_log.py``)
held to PyYAML both ways: PyYAML's ``safe_load`` of the port's text is
the dict, and the port's reader of ``safe_dump``'s text (as the JAX
package appends it, at PyYAML's line width and a narrow one that folds
long strings) is what ``safe_load_all`` reads; the log the port's store
appends is read by the JAX package's store; anything outside the subset
raises with its name."""

from __future__ import annotations

import math

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from dmd_era5_tpu.pipeline import artifacts as store_jax
from dmd_era5_tpu_torch.pipeline import artifacts, store_log

TEXT = st.text(st.characters(blacklist_categories=("Cs",)), max_size=120)
KEYS = st.text("abcdefghijklmnopqrstuvwxyz_0123456789", min_size=1, max_size=24)
SCALARS = st.one_of(
    TEXT, st.integers(-2**70, 2**70), st.booleans(), st.none(),
    st.floats(allow_nan=False), st.sampled_from(["yes", "Off", "~", "null", "0x1F", "0777",
                                                 "1_000", "12:30:05", "2019-01-01",
                                                 "2026-10-18T08:40:43.1+00:00", ".inf", "-.5",
                                                 "3.", "- a", "a: b", "#c", "'q'", '"d"', " lead",
                                                 "trail ", "", "[]", "{}", "&x", "*y", "!t"]))
ATTRS = st.dictionaries(KEYS, st.one_of(SCALARS, st.lists(SCALARS, max_size=5)), max_size=8)
LOG = st.dictionaries(st.text("0123456789abcdef", min_size=32, max_size=32), ATTRS,
                      min_size=1, max_size=3)


def _same(a, b) -> bool:
    """Equal, NaN equal to NaN (repr compares floats by their digits)."""
    return repr(a) == repr(b)


@settings(max_examples=200, deadline=None, database=None)
@given(LOG)
def test_port_text_reads_in_pyyaml_as_the_dict(log):
    assert _same(yaml.safe_load(store_log.dump(log)), log)
    assert _same(store_log.load_all(store_log.dump(log)), [log])


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(LOG, min_size=1, max_size=3), st.sampled_from([80, 24]))
def test_pyyaml_text_reads_in_the_port_as_in_pyyaml(entries, width):
    """Entries appended one after another, as both stores append them:
    one document of several top-level keys."""
    text = "".join(yaml.safe_dump(e, sort_keys=False, width=width) for e in entries)
    assert _same(store_log.load_all(text), list(yaml.safe_load_all(text)))


def test_documents_markers_and_nan():
    text = "---\na: .nan\nb: [ ]\nc: {}\n...\n---\n'q': ''\n---\n"
    ref = list(yaml.safe_load_all(text))
    got = store_log.load_all(text)
    assert math.isnan(got[0]["a"]) and math.isnan(ref[0]["a"])
    assert got[0]["b"] == ref[0]["b"] == [] and got[0]["c"] == ref[0]["c"] == {}
    assert got[1:] == ref[1:] == [{"q": ""}, None]


@pytest.mark.parametrize("text, name", [
    ("a: &x 1\n", "anchor"),
    ("a: *x\n", "alias"),
    ("a: !!str 1\n", "tag"),
    ("a: |\n  text\n", "literal block scalar"),
    ("a: >\n  text\n", "folded block scalar"),
    ("a: [1, 2]\n", "flow collection"),
    ("? a\n: 1\n", "complex mapping key"),
    ("a: 2001-12-14\n", "timestamp"),
    ("<<: 1\n", "merge"),
    ("a:\n- - 1\n", "nested list"),
    ("a:\n- b: 1\n", "mapping in a list"),
    ("a: 'open\n", "unterminated"),
    ("a: \"\\q\"\n", "unknown escape"),
    ("a: 1\n  b: 2\n", "mapping value inside a plain scalar|unexpected"),
])
def test_text_outside_the_subset_is_refused_by_name(text, name):
    with pytest.raises(store_log.StoreLogError, match=name):
        store_log.load_all(text)


def test_values_outside_the_subset_are_refused():
    with pytest.raises(store_log.StoreLogError, match="lists hold scalars"):
        store_log.dump({"m": {"a": [[1]]}})
    with pytest.raises(store_log.StoreLogError, match="bytes"):
        store_log.dump({"m": {"a": b"x"}})


def test_a_log_the_port_appends_serves_the_jax_store(tmp_path, monkeypatch):
    """``add_data_to_store`` appends through the port's writer; the JAX
    package's ``list_versions`` (PyYAML) reads every entry as the port's
    reader does."""
    monkeypatch.setenv("DMD_ERA5_TPU_ROOT", str(tmp_path))
    monkeypatch.delenv("DMD_ERA5_TPU_REMOTE", raising=False)
    data = tmp_path / "a.h5"
    attrs = {"variables": ["temperature"], "levels": [1000], "source_path": "mock_data",
             "note": "a long note " * 12, "ratio": 0.25, "flag": True, "none": None}
    for i in range(3):
        data.write_bytes(b"artifact %d" % i)
        artifacts.add_data_to_store(data, {**attrs, "i": i})
    ours = artifacts.list_versions(data, data_type="era5_slice")
    theirs = store_jax.list_versions(data, data_type="era5_slice")
    assert ours == theirs and [a["i"] for _, a in ours] == [0, 1, 2]
    assert all({k: a[k] for k in attrs} == attrs for _, a in ours)
