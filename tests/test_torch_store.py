"""Parity of the port's artifact store with the JAX package's.

The store cases of tests/test_06_pipeline.py and the four remote
lifecycle cases of tests/test_18_store_remote.py on the port, and the
cross-package cases: a store (objects, YAML logs, remote) written by
either package serves the other.  Each test has a root of its own
(``DMD_ERA5_TPU_ROOT``), which both packages read.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np
import pytest

from dmd_era5_tpu.pipeline import artifacts as store_jax
from dmd_era5_tpu.utils import io_h5 as io_jax
from dmd_era5_tpu_torch.core import config_parser
from dmd_era5_tpu_torch.core.paths import repo_root
from dmd_era5_tpu_torch.pipeline.artifacts import (
    _objects_dir,
    add_data_to_dvc,
    add_data_to_store,
    fetch_from_remote,
    file_md5,
    list_versions,
    push_to_remote,
    retrieve_by_md5,
    retrieve_data_from_dvc,
    retrieve_data_from_store,
    retrieve_latest_from_store,
)
from dmd_era5_tpu_torch.snapmat import create_mock_era5
from dmd_era5_tpu_torch.utils.io_h5 import load_fieldset, save_fieldset

pytestmark = pytest.mark.tier2


@pytest.fixture()
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("DMD_ERA5_TPU_ROOT", str(tmp_path / "root"))
    monkeypatch.delenv("DMD_ERA5_TPU_REMOTE", raising=False)
    return tmp_path / "root"


@pytest.fixture()
def remote_dir(tmp_path, monkeypatch):
    remote = tmp_path / "store_remote"
    monkeypatch.setenv("DMD_ERA5_TPU_REMOTE", str(remote))
    return remote


def dl_config(**overrides):
    return {
        "source_path": "mock_data",
        "start_datetime": "2019-01-01T00",
        "end_datetime": "2019-01-01T06",
        "delta_time": "1h",
        "variables": "temperature",
        "levels": "1000",
        **overrides,
    }


def make_slice(parsed, variables=("temperature",), seed=0, offset=0.0):
    fs = create_mock_era5("2019-01-01", "2019-01-01T06", list(variables), [1000], seed=seed)
    if offset:
        first = fs.variables[0]
        fs[first].data = fs[first].data + offset
    fs.attrs.update(variables=list(variables), levels=[1000], source_path=parsed["source_path"])
    save_fieldset(fs, parsed["save_path"])
    return fs


# --------------------------------------------- tests/test_06_pipeline.py


def test_store_add_and_retrieve(root):
    parsed = config_parser(dl_config(source_path="gs://mock-bucket/era5.zarr"), "era5-download")
    fs = make_slice(parsed)
    md5 = add_data_to_store(parsed["save_path"], fs.attrs)
    assert md5 == file_md5(parsed["save_path"])
    assert (root / "store" / "objects" / md5).exists()
    os.remove(parsed["save_path"])
    path = retrieve_data_from_store(parsed, "era5_slice")
    assert path.exists()
    assert load_fieldset(path).attrs["variables"] == ["temperature"]


def test_store_no_match_raises(root):
    parsed = config_parser(dl_config(), "era5-download")
    parsed["variables"] = ["v_component_of_wind"]
    with pytest.raises((FileNotFoundError, ValueError)):
        retrieve_data_from_store(parsed, "era5_slice")


def test_store_version_multiplexing(root):
    """Two configs sharing a filename resolve to their own versions."""
    parsed = config_parser(dl_config(), "era5-download")
    for variables in (["temperature"], ["u_component_of_wind"]):
        fs = make_slice(parsed, variables, seed=1)
        add_data_to_dvc(parsed["save_path"], fs.attrs)
    retrieve_data_from_dvc(dict(parsed, variables=["temperature"]), "era5_slice")
    assert load_fieldset(parsed["save_path"]).attrs["variables"] == ["temperature"]
    retrieve_data_from_store(dict(parsed, variables=["u_component_of_wind"]), "era5_slice")
    assert load_fieldset(parsed["save_path"]).attrs["variables"] == ["u_component_of_wind"]
    with pytest.raises(ValueError, match="Unsupported data_type"):
        retrieve_data_from_store(parsed, "era5_other")


def test_store_missing_object_raises(root):
    parsed = config_parser(dl_config(start_datetime="2019-04-01T00", end_datetime="2019-04-01T12"),
                           "era5-download")
    fs = make_slice(parsed)
    md5 = add_data_to_store(parsed["save_path"], fs.attrs)
    os.remove(parsed["save_path"])
    os.remove(repo_root() / "store" / "objects" / md5)
    with pytest.raises(FileNotFoundError, match="missing from store"):
        retrieve_data_from_store(parsed, "era5_slice")


# -------------------------------------- tests/test_18_store_remote.py


def test_add_pushes_to_remote(root, remote_dir):
    parsed = config_parser(dl_config(), "era5-download")
    fs = make_slice(parsed)
    md5 = add_data_to_store(parsed["save_path"], fs.attrs)
    assert (remote_dir / md5).exists(), "add must push to the default remote"


def test_refetch_after_local_wipe(root, remote_dir):
    parsed = config_parser(dl_config(), "era5-download")
    fs = make_slice(parsed)
    md5 = add_data_to_store(parsed["save_path"], fs.attrs)
    os.remove(parsed["save_path"])
    os.remove(_objects_dir() / md5)
    path = retrieve_data_from_store(parsed, "era5_slice")
    assert path.exists()
    assert (_objects_dir() / md5).exists(), "fetch must repopulate the cache"
    assert load_fieldset(path).attrs["variables"] == ["temperature"]


def test_no_remote_configured(root):
    parsed = config_parser(dl_config(), "era5-download")
    fs = make_slice(parsed)
    md5 = add_data_to_store(parsed["save_path"], fs.attrs)
    assert push_to_remote(md5) is False
    assert fetch_from_remote(md5) is False
    os.remove(parsed["save_path"])
    os.remove(_objects_dir() / md5)
    with pytest.raises(FileNotFoundError):
        retrieve_data_from_store(parsed, "era5_slice")


def test_as_of_time_travel(root):
    parsed = config_parser(dl_config(), "era5-download")
    fs = make_slice(parsed)
    md5_v1 = add_data_to_store(parsed["save_path"], fs.attrs)
    fs = make_slice(parsed, offset=1.0)
    md5_v2 = add_data_to_store(parsed["save_path"], fs.attrs)
    assert md5_v1 != md5_v2

    versions = list_versions(parsed["save_path"], data_type="era5_slice")
    assert [m for m, _ in versions] == [md5_v1, md5_v2]
    v1_time = versions[0][1]["_store_logged_at"]
    assert file_md5(retrieve_data_from_store(parsed, data_type="era5_slice")) == md5_v2
    assert file_md5(retrieve_data_from_store(parsed, data_type="era5_slice", as_of=v1_time)) == md5_v1
    assert file_md5(retrieve_data_from_store(parsed, data_type="era5_slice", as_of=0)) == md5_v1
    with pytest.raises(ValueError, match="as of"):
        retrieve_data_from_store(parsed, data_type="era5_slice", as_of="1990-01-01T00:00:00+00:00")
    v1_naive = datetime.fromisoformat(v1_time).replace(tzinfo=None)
    assert file_md5(retrieve_data_from_store(parsed, data_type="era5_slice", as_of=v1_naive)) == md5_v1
    with pytest.raises(ValueError, match="as of"):
        retrieve_data_from_store(parsed, data_type="era5_slice", as_of="1990-01-01T00:00:00")
    with pytest.raises(TypeError, match="as_of"):
        retrieve_data_from_store(parsed, data_type="era5_slice", as_of=True)


# ------------------------------------------------------- across packages


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_written_by_one_package_serves_the_other(root, remote_dir, writer):
    """Versions, the log's matching and time travel, retrieval by md5,
    the newest match across logs, and the remote fallback: one package
    adds, the other lists and retrieves."""
    add = store_jax.add_data_to_store if writer == "jax" else add_data_to_store
    other = store_jax if writer == "port" else None
    parsed = config_parser(dl_config(), "era5-download")
    fs = make_slice(parsed)
    md5_v1 = add(parsed["save_path"], fs.attrs)
    fs = make_slice(parsed, offset=2.0)
    md5_v2 = add(parsed["save_path"], fs.attrs)

    def reader(name):
        return getattr(other, name) if other is not None else globals()[name]

    listed = reader("list_versions")(parsed["save_path"], data_type="era5_slice")
    assert [m for m, _ in listed] == [md5_v1, md5_v2]
    assert listed[0][1]["variables"] == ["temperature"] and listed[0][1]["levels"] == [1000]
    assert file_md5(reader("retrieve_data_from_store")(parsed, "era5_slice")) == md5_v2
    assert file_md5(reader("retrieve_data_from_store")(parsed, "era5_slice", as_of=0)) == md5_v1
    target = root / "elsewhere.h5"
    assert file_md5(reader("retrieve_by_md5")(md5_v1, target)) == md5_v1
    assert file_md5(reader("retrieve_latest_from_store")(parsed, "era5_slice")) == md5_v2
    # the local cache wiped: both objects come back from the remote
    for md5 in (md5_v1, md5_v2):
        os.remove(_objects_dir() / md5)
    assert file_md5(reader("retrieve_data_from_store")(parsed, "era5_slice")) == md5_v2
    assert (_objects_dir() / md5_v2).exists()
    np.testing.assert_array_equal(load_fieldset(parsed["save_path"])["temperature"].values,
                                  io_jax.load_fieldset(parsed["save_path"])["temperature"].values)


def test_logs_of_both_packages_interleave(root):
    """One log appended to by both packages, in turns, reads as one
    version history in each; one file gives both the same md5."""
    parsed = config_parser(dl_config(), "era5-download")
    md5s = []
    for i, add in enumerate((store_jax.add_data_to_store, add_data_to_store,
                             store_jax.add_data_to_store)):
        fs = make_slice(parsed, offset=float(i))
        md5s.append(add(parsed["save_path"], fs.attrs))
        assert md5s[-1] == file_md5(parsed["save_path"]) == store_jax.file_md5(parsed["save_path"])
    ours = list_versions(parsed["save_path"], data_type="era5_slice")
    theirs = store_jax.list_versions(parsed["save_path"], data_type="era5_slice")
    assert [m for m, _ in ours] == [m for m, _ in theirs] == md5s
    assert file_md5(store_jax.retrieve_data_from_store(parsed, "era5_slice", as_of=1)) == md5s[1]
    assert file_md5(retrieve_data_from_store(parsed, "era5_slice", as_of=0)) == md5s[0]
    assert file_md5(retrieve_data_from_store(parsed, "era5_slice")) == md5s[2]
