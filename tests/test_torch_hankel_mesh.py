"""Parity of the port's Hankel operators on a mesh with the JAX package's.

tests/test_08_kernels.py's mesh cases (:107, :121, :157, :188, :216,
:405, :471) and tests/test_21_comm_pattern.py's Hankel bounds (:91,
:223, :249) read from each rank's ``collective_log``: the port's
``ops.hankel`` on P gloo ranks (spawned once per P for the whole file,
``torch_mesh_ranks``), P in {2, 3, 4} (4 as (1, 2, 2) for the grid
cases), against the JAX functions at test_08's tolerances.  The
randomized cases pass the JAX-drawn sketch to the ranks.  The
space-sharded U comes back as each rank's interleaved block and is put
delay-major by ``parallel.assemble_rows``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_mesh_ranks import Ranks

from dmd_era5_tpu.ops import hankel as jh
from dmd_era5_tpu.parallel import make_mesh as jmake_mesh
from dmd_era5_tpu.snapmat.transform import delay_embed_np

WORLDS = (2, 3, 4)
GRID = "data=1,space=2,time=2"


def jax_omega(seed: int, t: int, r: int) -> np.ndarray:
    """The sketch the JAX randomized SVDs draw from ``seed``."""
    return np.asarray(jax.random.normal(jax.random.key(seed), (t, r), dtype=jnp.float32))


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    planted = (rng.standard_normal((512, 8)) * (np.arange(8, 0, -1) ** 2)
               @ rng.standard_normal((8, 48)))
    planted += 0.05 * rng.standard_normal((512, 48))
    out = {
        "sk": rng.standard_normal((32, 48)).astype(np.float32),
        "sk_omega2": rng.standard_normal((47, 4)).astype(np.float32),
        "sk_omega3": rng.standard_normal((46, 4)).astype(np.float32),
        "emb": rng.standard_normal((8, 48)).astype(np.float32),
        "unf": rng.standard_normal((512, 48)).astype(np.float32),
        "fused": planted.astype(np.float32),
        "comm": rng.standard_normal((1024, 48)).astype(np.float32),
        "g2": rng.standard_normal((64, 48)).astype(np.float32),
        "gpad": np.pad(rng.standard_normal((64, 45)), ((0, 0), (0, 3))).astype(np.float32),
        "gcomm": rng.standard_normal((2048, 64)).astype(np.float32),
    }
    out.update(omega_unf=jax_omega(7, 46, 16), omega_fused=jax_omega(7, 46, 34),
               omega_comm=jax_omega(0, 46, 16), omega_g2=jax_omega(7, 47, 16),
               omega_g3=jax_omega(7, 46, 16), omega_gpad=jax_omega(3, 43, 16),
               omega_gcomm=jax_omega(0, 62, 18))
    return out


def _cases(p: int) -> list[dict]:
    def case(name, fn="hankel_case", **args):
        return {"name": name, "fn": fn, "args": args}

    cases = [
        case("sketch2", op="sketch", x="sk", d=2, shape=f"time={p}", omega="sk_omega2"),
        case("sketch3", op="sketch", x="sk", d=3, shape=f"time={p}", omega="sk_omega3"),
        case("embed", op="embed", x="emb", d=3, shape=f"time={p}"),
        case("unfused", op="sharded", x="unf", d=3, k=6, omega="omega_unf", fused=False),
        case("fused", op="sharded", x="fused", d=3, k=6, omega="omega_fused", oversamples=28),
        case("exact", op="exact", x="unf", d=3, k=6),
        case("comm_fused", op="sharded", x="comm", d=3, k=6, omega="omega_comm"),
        case("comm_exact", op="exact", x="comm", d=3, k=6),
    ]
    if p == 4:
        cases += [
            case("grid2", "grid_case", op="hankel2d", x="g2", d=2, k=6, shape=GRID,
                 omega="omega_g2"),
            case("grid3", "grid_case", op="hankel2d", x="g2", d=3, k=6, shape=GRID,
                 omega="omega_g3"),
            case("gpad", "grid_case", op="hankel2d", x="gpad", d=3, k=6, shape=GRID,
                 omega="omega_gpad", t_valid=45),
            case("gcomm", "grid_case", op="hankel2d", x="gcomm", d=3, k=8, shape=GRID,
                 omega="omega_gcomm"),
        ]
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("hankel_mesh")
    inputs = _inputs()
    return {p: Ranks(p, _cases(p), inputs, base / f"p{p}", timeout=240) for p in WORLDS}, inputs


def _alike(outs, name: str, keys=("u", "s", "v")):
    for o in outs[1:]:
        for key in keys:
            np.testing.assert_array_equal(o[f"{name}/{key}"], outs[0][f"{name}/{key}"])
    return outs[0]


PSUM = 0  # torch_mesh_ranks' op code


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("d", [2, 3])
def test_hankel_sketch_time_sharded(worlds, p, d):
    """test_08:107: Y = H_d(X) Omega over P time ranks equals the
    materialized product (rtol 1e-4, atol 1e-3) and the JAX function on
    time=8; every rank holds all of it, summed by one psum."""
    ranks, inputs = worlds
    x, omega = inputs["sk"], inputs[f"sk_omega{d}"]
    expected = delay_embed_np(x, d) @ omega
    ref = np.asarray(jh.hankel_sketch_time_sharded(jnp.asarray(x), jnp.asarray(omega), d,
                                                   jmake_mesh("time=8")))
    for o in ranks[p].wait():
        np.testing.assert_allclose(o[f"sketch{d}/out"], expected, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(o[f"sketch{d}/out"], ref, rtol=1e-4, atol=1e-3)
        assert (o[f"sketch{d}/log"][:, 0] == PSUM).all() and len(o[f"sketch{d}/log"]) == 1


@pytest.mark.parametrize("p", WORLDS)
def test_delay_embed_time_sharded(worlds, p):
    """test_08:121: the ranks' blocks side by side are (S d, T); from
    column d-1 on they equal the host embedding (1e-6), and the whole
    matches the JAX blocks on time=4 (zeros left of the first window)."""
    ranks, inputs = worlds
    x, d = inputs["emb"], 3
    outs = sorted(ranks[p].wait(), key=lambda o: int(o["embed/index"]))
    out = np.concatenate([o["embed/out"] for o in outs], axis=1)
    assert out.shape == (8 * d, 48)
    np.testing.assert_allclose(out[:, d - 1:], delay_embed_np(x, d), atol=1e-6)
    ref = np.asarray(jh.delay_embed_time_sharded(jnp.asarray(x), d, jmake_mesh("time=4")))
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("p", WORLDS)
def test_hankel_randomized_svd_sharded_matches_single(worlds, p):
    """test_08:157: the unfused space-sharded body (K6, tree TSQR, K3)
    against JAX's single-device operator SVD on the same sketch (s rtol
    1e-3, U and V atol 2e-3), U gathered delay-major."""
    ranks, inputs = worlds
    got = _alike(ranks[p].wait(), "unfused")
    ref = jh.hankel_randomized_svd(jnp.asarray(inputs["unf"]), 3, 6, seed=7)
    np.testing.assert_allclose(got["unfused/s"], np.asarray(ref.s), rtol=1e-3)
    np.testing.assert_allclose(got["unfused/u"], np.asarray(ref.U), atol=2e-3)
    np.testing.assert_allclose(got["unfused/v"], np.asarray(ref.V), atol=2e-3)


@pytest.mark.parametrize("p", WORLDS)
def test_hankel_randomized_svd_sharded_fused_matches_single_fused(worlds, p):
    """test_08:405: the fused space-sharded body (K1 a pass) against the
    JAX single-device fused SVD in f32 on the same sketch (s rtol 1e-4,
    U and V atol 1e-3)."""
    ranks, inputs = worlds
    got = _alike(ranks[p].wait(), "fused")
    ref = jh.hankel_randomized_svd_fused(jnp.asarray(inputs["fused"]), 3, 6,
                                         gemm_dtype=jnp.float32, seed=7)
    np.testing.assert_allclose(got["fused/s"], np.asarray(ref.s), rtol=1e-4)
    np.testing.assert_allclose(got["fused/u"], np.asarray(ref.U), atol=1e-3)
    np.testing.assert_allclose(got["fused/v"], np.asarray(ref.V), atol=1e-3)


@pytest.mark.parametrize("p", WORLDS)
def test_hankel_exact_svd_sharded_matches_single(worlds, p):
    """test_08:471: the space-sharded exact Hankel SVD against the JAX
    one on one device (s rtol 1e-4; U and V atol 2e-4, up to a sign a
    component: the exact route flips none, and the two libraries'
    small SVDs may sign a vector either way)."""
    ranks, inputs = worlds
    got = _alike(ranks[p].wait(), "exact")
    ref = jh.hankel_exact_svd(jnp.asarray(inputs["unf"]), 3, 6)
    np.testing.assert_allclose(got["exact/s"], np.asarray(ref.s), rtol=1e-4)
    signs = np.sign(np.sum(got["exact/u"] * np.asarray(ref.U), axis=0))
    np.testing.assert_allclose(got["exact/u"] * signs, np.asarray(ref.U), atol=2e-4)
    np.testing.assert_allclose(got["exact/v"] * signs[:, None], np.asarray(ref.V), atol=2e-4)


@pytest.mark.parametrize("d", [2, 3])
def test_hankel_randomized_svd_2d_matches_single(worlds, d):
    """test_08:188 on (1, 2, 2): the grid-sharded operator SVD against
    JAX's single-device one on the same sketch (s rtol 1e-3, U and V
    atol 2e-3), and s against the JAX grid SVD on space=2, time=4."""
    ranks, inputs = worlds
    got = _alike(ranks[4].wait(), f"grid{d}")
    x = inputs["g2"]
    ref = jh.hankel_randomized_svd(jnp.asarray(x), d, 6, seed=7)
    np.testing.assert_allclose(got[f"grid{d}/s"], np.asarray(ref.s), rtol=1e-3)
    np.testing.assert_allclose(got[f"grid{d}/u"], np.asarray(ref.U), atol=2e-3)
    np.testing.assert_allclose(got[f"grid{d}/v"], np.asarray(ref.V), atol=2e-3)
    mesh = jmake_mesh("space=2,time=4")
    res = jh.hankel_randomized_svd_2d(jax.device_put(x, NamedSharding(mesh, P("space", "time"))),
                                      d, 6, mesh, seed=7)
    np.testing.assert_allclose(got[f"grid{d}/s"], np.asarray(res.s), rtol=1e-3)


def test_hankel_randomized_svd_2d_column_padding(worlds):
    """test_08:216: T = 45 zero-padded to 48 on the time ranks; padded
    windows are left out by ``t_valid``: V has 43 columns and the factors
    match the single-device SVD of the unpadded X (s rtol 1e-3, U and V
    atol 2e-3)."""
    ranks, inputs = worlds
    got = _alike(ranks[4].wait(), "gpad")
    ref = jh.hankel_randomized_svd(jnp.asarray(inputs["gpad"][:, :45]), 3, 6, seed=3)
    assert got["gpad/v"].shape == (6, 43)
    np.testing.assert_allclose(got["gpad/s"], np.asarray(ref.s), rtol=1e-3)
    np.testing.assert_allclose(got["gpad/u"], np.asarray(ref.U), atol=2e-3)
    np.testing.assert_allclose(got["gpad/v"], np.asarray(ref.V), atol=2e-3)


@pytest.mark.parametrize("p", WORLDS)
def test_hankel_sharded_collectives_are_small(worlds, p):
    """test_21:223 (fused: only the (r, r) Gram and the (r, T-d+1)
    projection cross ranks, r = k + 10) and :249 (exact: nothing past the
    (T, T) raw Gram), on every rank: psums only."""
    ranks, _ = worlds
    r, t, d = 16, 48, 3
    for o in ranks[p].wait():
        for name, bound in (("comm_fused", r * (t - d + 1)), ("comm_exact", t * t)):
            log = o[f"{name}/log"]
            assert len(log) and (log[:, 0] == PSUM).all(), log
            assert log[:, 2].max() <= bound, (name, log)


def test_hankel_2d_collectives_are_small(worlds):
    """test_21:91 on (1, 2, 2): only the sketch's (d S_loc, r) sum over
    time scales with rows; halos, projections and R merges are small."""
    ranks, _ = worlds
    d, s, r = 3, 2048, 18
    for o in ranks[4].wait():
        log = o["gcomm/log"]
        assert len(log) and log[:, 2].max() <= d * (s // 2) * r, log
