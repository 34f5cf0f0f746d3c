"""Parity of the port's meshed fit step with the JAX package's.

tests/test_07_train_step.py's mesh cases (:104, :145) and
tests/test_21_comm_pattern.py's fit-step bounds (:44, :202): the port's
``make_fit_step`` on 8 gloo ranks (spawned once for the file,
``torch_mesh_ranks``) against JAX ``make_fit_step`` on the conftest's 8
virtual CPU devices, on the same numpy batch: the fused sharded step
(data=2, space=4; K1's plain version once per local entry here), the
portable step (data=2, space=2, time=2), the hybrid mesh (dcn data=2
over two slices of four) and ``__graft_entry__.dryrun_multichip(8)``'s
step.  Singular values, loss and the POD subspace at test_07's
tolerances; every collective of a time-unsharded mesh within
B_loc r T elements, and only scalars crossing ``data``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_mesh_ranks import Ranks

from dmd_era5_tpu.parallel import make_hybrid_mesh as jmake_hybrid_mesh
from dmd_era5_tpu.parallel import make_mesh as jmake_mesh
from dmd_era5_tpu.pipeline.train_step import make_fit_step as jmake_fit_step

B, S, T, R, K = 4, 256, 64, 16, 8
MESHES = {
    "fused": {"shape": "data=2,space=4"},
    "portable": {"shape": "data=2,space=2,time=2"},
    "hybrid": {"dcn": "data=2"},
}
DATA, SPACE, TIME = 0, 1, 2  # axis codes of torch_mesh_ranks' logs


def _batch():
    rng = np.random.default_rng(7)
    x = np.einsum("bsr,brt->bst", rng.standard_normal((B, S, 12)),
                  rng.standard_normal((B, 12, T))).astype(np.float32)
    return x, rng.standard_normal((T, R)).astype(np.float32)


def _dryrun_batch():
    """``dryrun_multichip(8)``'s inputs: mesh (2, 2, 2), batch 2 d, rows
    64 s, columns 16 t, sketch 8, numpy draws of seed 0."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 128, 32)).astype(np.float32)
    return x, rng.standard_normal((32, 8)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x, omega = _batch()
    xd, omega_d = _dryrun_batch()
    cases = [{"name": name, "fn": "fit_case", "args": {**args, "k": K}}
             for name, args in MESHES.items()]
    cases.append({"name": "dryrun", "fn": "fit_case",
                  "args": {"shape": "data=2,space=2,time=2", "k": 4, "x": "xd",
                           "omega": "omega_d"}})
    return Ranks(8, cases, {"x": x, "omega": omega, "xd": xd, "omega_d": omega_d},
                 tmp_path_factory.mktemp("fit_mesh"))


def _jax_mesh(name: str):
    if name == "hybrid":
        return jmake_hybrid_mesh(dcn_shape="data=2", n_slices=2)
    return jmake_mesh(MESHES[name]["shape"])


def _assemble(outs, name: str, b_loc: int):
    """The whole batch's u, s, v, a_red from the ranks' blocks."""
    u = np.zeros((B, S, K), np.float32)
    s, v, a = np.zeros((B, K)), np.zeros((B, K, T)), np.zeros((B, K, K))
    s_loc = None
    for o in outs:
        d, sp, t = o[f"{name}/coords"]
        blk = slice(d * b_loc, (d + 1) * b_loc)
        s_loc = o[f"{name}/u"].shape[1]
        u[blk, sp * s_loc:(sp + 1) * s_loc] = o[f"{name}/u"]
        s[blk], v[blk], a[blk] = o[f"{name}/s"], o[f"{name}/v"], o[f"{name}/a_red"]
    return u, s, v, a


@pytest.mark.parametrize("name", list(MESHES))
def test_fit_step_matches_jax_make_fit_step(ranks, name):
    x, omega = _batch()
    ref = jmake_fit_step(_jax_mesh(name), n_components=K)(jnp.asarray(x), jnp.asarray(omega))
    outs = ranks.wait()
    u, s, v, a_red = _assemble(outs, name, B // 2)
    np.testing.assert_allclose(s, np.asarray(ref.s), rtol=2e-3, atol=1e-3)
    for o in outs:  # the loss is over the whole batch on every rank
        np.testing.assert_allclose(float(o[f"{name}/loss"]), float(ref.loss), atol=1e-3)
    for b in range(B):
        qa, _ = np.linalg.qr(u[b])
        qb, _ = np.linalg.qr(np.asarray(ref.u)[b])
        assert np.linalg.svd(qa.T @ qb, compute_uv=False).min() > 1 - 1e-3
        # a_red up to the SVD's per-component signs, aligned through v
        d = np.diag(np.sign(np.sum(v[b] * np.asarray(ref.v)[b], axis=1)))
        np.testing.assert_allclose(d @ a_red[b] @ d, np.asarray(ref.a_red)[b], atol=5e-3)


@pytest.mark.parametrize("name", ["fused", "hybrid"])
def test_time_unsharded_collectives_are_small(ranks, name):
    """test_21 :44 and :202: with the time axis whole every collective is
    at most the (B_loc, r, T) projection sum, and on the hybrid mesh only
    scalars (the loss's two sums) cross ``data``."""
    for o in ranks.wait():
        log = o[f"{name}/log"]
        assert len(log) and log[:, 2].max() <= (B // 2) * R * T
        on_data = log[log[:, 1] == DATA]
        assert len(on_data) == 1 and on_data[:, 2].max() <= 2


def test_portable_collectives_carry_the_sketch_sum_only_over_time(ranks):
    """The portable step's one S-sized sum is the time-axis sum of the
    local sketch X_loc Omega_loc (S_loc x r a rank); every space-axis
    collective stays r-sized, and B is gathered over time once."""
    s_loc, t_loc = S // 2, T // 2
    for o in ranks.wait():
        log = o["portable/log"]
        on_time, on_space = log[log[:, 1] == TIME], log[log[:, 1] == SPACE]
        assert on_time[:, 2].max() == (B // 2) * s_loc * R
        assert on_space[:, 2].max() <= (B // 2) * R * max(R, t_loc)
        assert (log[:, 0] == 1).sum() == 1  # one all_gather: B over time
        assert log[log[:, 1] == DATA][:, 2].max() <= 2


def test_dryrun_multichip_fit_step_loss(ranks):
    """``__graft_entry__.dryrun_multichip(8)``'s fit step on a (2, 2, 2)
    mesh with its numpy inputs: the same loss as the JAX step."""
    x, omega = _dryrun_batch()
    ref = jmake_fit_step(jmake_mesh("data=2,space=2,time=2"), n_components=4)(x, omega)
    losses = [float(o["dryrun/loss"]) for o in ranks.wait()]
    assert np.isfinite(losses).all() and len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], float(ref.loss), atol=1e-3)


def test_jax_mesh_and_port_rank_grid_agree():
    """The meshes the comparisons above pair: the port's rank grid is the
    JAX device grid's ids, the hybrid one's DCN-major interleave too."""
    from dmd_era5_tpu_torch.parallel import make_hybrid_mesh, make_mesh

    for name in MESHES:
        args = MESHES[name]
        port = (make_hybrid_mesh(None, args["dcn"], ranks=range(8), n_slices=2, device="cpu")
                if "dcn" in args else make_mesh(args["shape"], ranks=range(8), device="cpu"))
        ids = np.vectorize(lambda dev: dev.id)(_jax_mesh(name).devices)
        np.testing.assert_array_equal(port.ranks, ids)
