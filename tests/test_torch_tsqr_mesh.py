"""Parity of the port's tree TSQR over a mesh axis with the JAX package's.

tests/test_03_svd.py's TSQR cases (:58-131) and
tests/test_21_comm_pattern.py's TSQR bound (:68): the port's ``tsqr`` on
P gloo ranks (spawned once per P for the whole file, ``torch_mesh_ranks``)
against JAX ``tsqr`` on a P-device mesh of the conftest's virtual CPU
devices, for P in {2, 3, 4, 6, 8}: R on every rank and the gathered Q at
test_03's ``atol=2e-4``, zero-padded rows, leaf blocks shorter than T
(the rank doubling), the CholQR2 leaves (K4's and K5's plain versions
here), and the exchanges: log2 P ``ppermute`` calls for a power of two,
ceil(log2 P) + 1 otherwise, on every rank, no all-gather, no payload
over 2 T^2 elements.
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
from torch_mesh_ranks import Ranks

from dmd_era5_tpu.ops.tsqr import qr_positive as jqr_positive
from dmd_era5_tpu.ops.tsqr import tsqr as jtsqr
from dmd_era5_tpu.parallel import make_mesh as jmake_mesh
from dmd_era5_tpu.parallel import shard_rows as jshard_rows

WORLDS = (2, 3, 4, 6, 8)
PSUM, ALL_GATHER, PPERMUTE = 0, 1, 2  # op codes of torch_mesh_ranks' logs


def _inputs(p: int) -> dict:
    rng = np.random.default_rng(p)
    return {
        "pad": rng.standard_normal((1003, 16)).astype(np.float32),  # rows pad to P
        "doubling": rng.standard_normal((16 * p, 24)).astype(np.float32),  # m_loc 16 < T
        "tall": rng.standard_normal((1024, 24)).astype(np.float32),
    }


CASES = [
    {"name": "pad", "fn": "tsqr_case", "args": {"x": "pad"}},
    {"name": "doubling", "fn": "tsqr_case", "args": {"x": "doubling"}},
    {"name": "cholqr2", "fn": "tsqr_case", "args": {"x": "tall", "method": "cholqr2"}},
    {"name": "cholqr2_split", "fn": "tsqr_case", "args": {"x": "tall", "method": "cholqr2_split"}},
]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world size's ranks, started together at once."""
    base = tmp_path_factory.mktemp("tsqr_mesh")
    return {p: (Ranks(p, CASES, _inputs(p), base / f"p{p}"), _inputs(p)) for p in WORLDS}


def _jax_tsqr(x: np.ndarray, p: int):
    mesh = jmake_mesh({"space": p}, devices=jax.devices()[:p])
    xs, _ = jshard_rows(x, mesh)
    q, r = jtsqr(xs, mesh)
    return np.asarray(q)[: x.shape[0]], np.asarray(r)


def _gathered_q(outs, name: str, rows: int) -> np.ndarray:
    return np.concatenate([o[f"{name}/q"] for o in outs])[:rows]


@pytest.mark.parametrize("p", WORLDS)
def test_tsqr_with_padding_matches_jax_on_every_rank(worlds, p):
    ranks, inputs = worlds[p]
    x = inputs["pad"]
    q_j, r_j = _jax_tsqr(x, p)
    outs = ranks.wait()
    for o in outs:  # R is replicated: each rank factors the same stacks
        np.testing.assert_array_equal(o["pad/r"], outs[0]["pad/r"])
        np.testing.assert_allclose(o["pad/r"], r_j, atol=2e-4)
    assert sum(o["pad/q"].shape[0] for o in outs) == -(-1003 // p) * p
    q = _gathered_q(outs, "pad", 1003)
    np.testing.assert_allclose(q, q_j, atol=2e-4)
    _, r_host = jqr_positive(jax.numpy.asarray(x))
    np.testing.assert_allclose(outs[0]["pad/r"], np.asarray(r_host), atol=2e-4)
    pad = np.concatenate([o["pad/q"] for o in outs])[1003:]
    np.testing.assert_array_equal(pad, 0.0)


@pytest.mark.parametrize("p", WORLDS)
def test_tsqr_exchange_count_and_payloads(worlds, p):
    """test_21's TSQR bound, per rank: only ppermute, log2 P of them for
    a power of two and ceil(log2 P) + 1 otherwise, each within 2 T^2."""
    ranks, inputs = worlds[p]
    want = int(math.log2(p)) if p & (p - 1) == 0 else math.ceil(math.log2(p)) + 1
    for name, t_cols in (("pad", 16), ("doubling", 24), ("cholqr2_split", 24)):
        for o in ranks.wait():
            log = o[f"{name}/log"]
            assert (log[:, 0] == PPERMUTE).all() and len(log) == want, (name, log)
            assert log[:, 2].max() <= 2 * t_cols * t_cols


def _host_qr(x: np.ndarray):
    """test_03's host oracle: the reduced QR with diag(R) >= 0."""
    q, r = np.linalg.qr(x.astype(np.float64))
    signs = np.where(np.diagonal(r) < 0, -1.0, 1.0)
    return q * signs, r * signs[:, None]


@pytest.mark.parametrize("p", [6, 8])
def test_tsqr_rank_doubling_matches_jax(worlds, p):
    """Leaf blocks shorter than T: the merged rank doubles each round until
    it caps at T, and Q R = X."""
    ranks, inputs = worlds[p]
    x = inputs["doubling"]
    q_j, r_j = _jax_tsqr(x, p)
    outs = ranks.wait()
    q = _gathered_q(outs, "doubling", x.shape[0])
    assert outs[0]["doubling/r"].shape == r_j.shape
    for o in outs:
        np.testing.assert_allclose(o["doubling/r"], r_j, atol=2e-4)
    np.testing.assert_allclose(q, q_j, atol=2e-4)
    np.testing.assert_allclose(q @ outs[0]["doubling/r"], x, atol=5e-4)
    np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=5e-4)


@pytest.mark.parametrize("method", ["cholqr2", "cholqr2_split"])
@pytest.mark.parametrize("p", [3, 8])
def test_tsqr_cholqr2_leaves_on_a_mesh(worlds, p, method):
    """The CholQR2 leaves (K4, K5 on a card; their plain versions here)
    under the tree combine: R is unique under diag(R) >= 0, so it
    matches test_03's host oracle at test_03's tolerance (the leaves'
    parity with the JAX leaves is test_torch_qr_panel's)."""
    ranks, inputs = worlds[p]
    x = inputs["tall"]
    q_j, r_j = _host_qr(x)
    outs = ranks.wait()
    for o in outs:
        np.testing.assert_allclose(o[f"{method}/r"], r_j, atol=2e-4)
    q = _gathered_q(outs, method, x.shape[0])
    np.testing.assert_allclose(q, q_j, atol=2e-4)
    np.testing.assert_allclose(q.T @ q, np.eye(24), atol=5e-5)
