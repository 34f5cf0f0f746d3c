"""Parity of the port's batched LM and BOP-DMD with the JAX package's.

The oscillator of tests/test_23_bopdmd.py (two damped conjugate pairs in
96 rows, 160 samples): ``varpro_lm_batched`` against the JAX one and
against the port's ``varpro_lm`` member by member (at test_23's atol
1e-4), with per-member and with shared sample times; ``bopdmd_from_svd``
at one seed against the JAX bag; the streamed aggregation of the trial
modes against the materialized (n_trials, S, r) formula; the errors.

The bag is compared at noise 0.1, where the trials' spread (the
resampling's, ~1e-3 of the eigenvalues) is well above the stopping
slack of each f32 LM fit (~1e-6): the reported standard deviations then
agree to 1e-3 relative.  At noise 0.01 the spread is itself of the order
of that slack, and two implementations' std differ by ~0.5%.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_23_bopdmd import TRUE_ALPHAS, _oscillator_data
from test_torch_optdmd import _match

from dmd_era5_tpu.models import bopdmd as bop_jax
from dmd_era5_tpu.models.optdmd import varpro_lm_batched as lm_batched_jax
from dmd_era5_tpu_torch import convert
from dmd_era5_tpu_torch.models import bopdmd, fit_bopdmd, varpro_lm, varpro_lm_batched


def _projected(noise=0.01, seed=0):
    x, t = _oscillator_data(noise=noise, seed=seed)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    return x, t, u[:, :4].copy(), s[:4].copy(), vt[:4].copy()


@pytest.mark.parametrize("shared_t", [False, True], ids=["per_member_t", "shared_t"])
def test_varpro_lm_batched(shared_t):
    """Each member of the batch is its own varpro_lm fit, and the batch
    equals the JAX package's vmapped one."""
    _, t, _, s, vt = _projected()
    h = (s[:, None] * vt).T  # (T, k)
    rng = np.random.default_rng(1)
    if shared_t:
        h_b, t_b = np.stack([h] * 3), t
        alpha0 = np.stack([TRUE_ALPHAS * f for f in (1.1, 0.9, 1.0)]).astype(np.complex64)
    else:
        idx = np.stack([np.sort(rng.choice(len(t), size=120, replace=False)) for _ in range(3)])
        h_b, t_b = h[idx], t[idx]
        alpha0 = np.tile(TRUE_ALPHAS[None, :] * 1.1, (3, 1)).astype(np.complex64)
    alpha, b, rel, n_iters = varpro_lm_batched(h_b, t_b, alpha0, max_iter=30)
    alpha_j, b_j, rel_j, _ = lm_batched_jax(h_b, t_b, alpha0, max_iter=30)
    assert alpha.shape == (3, 4) and alpha.dtype == np.complex64
    assert b.shape == (3, 4, 4) and rel.shape == n_iters.shape == (3,)
    assert all(isinstance(a, np.ndarray) for a in (alpha, b, rel, n_iters))
    np.testing.assert_allclose(rel, rel_j, rtol=1e-3)
    for i in range(3):
        t_i = t_b if shared_t else t_b[i]
        a_i, b_i, rel_i, _ = varpro_lm(torch.from_numpy(h_b[i]).to(torch.complex64),
                                       torch.from_numpy(t_i), torch.from_numpy(alpha0[i]),
                                       max_iter=30)
        for want in (a_i.numpy(), alpha_j[i]):
            np.testing.assert_allclose(alpha[i][_match(alpha[i], want)], want, atol=1e-4)
        np.testing.assert_allclose(rel[i], float(rel_i), rtol=1e-3)
        np.testing.assert_allclose(np.abs(b[i]), np.abs(b_i.numpy()), rtol=1e-3, atol=1e-3)
        assert 1 <= n_iters[i] <= 30


def test_varpro_lm_batched_leaves_a_finished_member_as_it_is():
    """A member capped at its first step (max_iter 1 for the batch) ends
    where a one-member run of one step ends, and members that run on do
    not move it."""
    _, t, _, s, vt = _projected()
    h = (s[:, None] * vt).T
    alpha0 = np.stack([TRUE_ALPHAS * 1.2, TRUE_ALPHAS]).astype(np.complex64)
    one_step = varpro_lm_batched(h[None], t, alpha0[:1], max_iter=1)
    both = varpro_lm_batched(np.stack([h, h]), t, alpha0, max_iter=1)
    np.testing.assert_allclose(both[0][0], one_step[0][0], atol=1e-6)
    assert both[3][0] == one_step[3][0] == 1
    long = varpro_lm_batched(np.stack([h, h]), t, alpha0, max_iter=40)
    alone = varpro_lm_batched(h[None], t, alpha0[1:], max_iter=40)
    np.testing.assert_allclose(long[0][1], alone[0][0], atol=1e-6)
    assert long[3][1] == alone[3][0]


def test_bopdmd_from_svd_matches_the_jax_bag():
    """One seed gives both packages the same trial subsets: the mean
    eigenvalues match to 1e-3, amplitudes and every std to 1e-3
    relative, the mean modes and the trials' eigenvalues slot by slot."""
    _, t, u, s, vt = _projected(noise=0.1, seed=5)
    kw = dict(rank=4, n_trials=10, trial_fraction=0.7, seed=7, max_iter=30)
    res = bopdmd.bopdmd_from_svd(torch.from_numpy(u), torch.from_numpy(s),
                                 torch.from_numpy(vt), torch.from_numpy(t), **kw)
    res_j = bop_jax.bopdmd_from_svd(jnp.asarray(u), jnp.asarray(s), jnp.asarray(vt),
                                    jnp.asarray(t), **kw)
    assert all(isinstance(a, torch.Tensor) for a in res if not isinstance(a, tuple))
    idx = _match(res.eigenvalues.numpy(), res_j.eigenvalues)  # slots: the anchors' orders
    np.testing.assert_allclose(res.eigenvalues.numpy()[idx], res_j.eigenvalues, atol=1e-3)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    assert rel(res.amplitudes.numpy()[idx], res_j.amplitudes) < 1e-3
    assert rel(res.eigenvalues_std.numpy()[idx], res_j.eigenvalues_std) < 1e-3
    assert rel(res.amplitudes_std.numpy()[idx], res_j.amplitudes_std) < 1e-3
    assert rel(res.modes_std.numpy()[:, idx], res_j.modes_std) < 1e-3
    np.testing.assert_allclose(res.modes.numpy()[:, idx], res_j.modes, atol=1e-4)
    np.testing.assert_allclose(res.trial_eigenvalues.numpy()[:, idx], res_j.trial_eigenvalues,
                               atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(res.modes.numpy(), axis=0), 1.0, rtol=1e-5)
    assert res.n_iters.shape == (10,) and len(res.trial_eigenvalues) == 10
    # the JAX bag's state crosses to the port's types unchanged
    back = convert.bopdmd_result_from_numpy(*res_j, device="cpu")
    np.testing.assert_array_equal(back.modes.numpy(), res_j.modes)
    np.testing.assert_array_equal(back.full.alpha.numpy(), res_j.full.alpha)


def test_fit_bopdmd_recovers_the_oscillator():
    """tests/test_23_bopdmd.py's class fixture, through the port."""
    x, t = _oscillator_data()
    res = fit_bopdmd(torch.from_numpy(x), torch.from_numpy(t), rank=4, n_trials=12,
                     trial_fraction=0.7, seed=3, max_iter=40)
    np.testing.assert_allclose(np.sort_complex(res.eigenvalues.numpy()),
                               np.sort_complex(TRUE_ALPHAS.astype(np.complex64)), atol=0.05)
    assert bool((res.eigenvalues_std >= 0).all()) and bool((res.eigenvalues_std < 0.2).all())
    assert res.modes_std.shape == res.modes.shape
    assert bool(torch.isfinite(res.modes_std).all())
    spread = (res.trial_eigenvalues - res.full.alpha[None, :]).abs()
    assert float(spread.max()) < 0.3


def test_streamed_aggregation_equals_the_materialized_formula():
    """Trial by trial, float64 sums: the mean modes (unit columns) and
    the modes std of the JAX formula over all (n_trials, S, r) modes."""
    rng = np.random.default_rng(9)
    n_rows, k, r, n_trials = 200, 6, 4, 7
    u, _ = np.linalg.qr(rng.standard_normal((n_rows, k)))
    u = u.astype(np.float32)
    base = rng.standard_normal((k, r)) + 1j * rng.standard_normal((k, r))
    coefs = np.stack([
        (base + 0.1 * (rng.standard_normal((k, r)) + 1j * rng.standard_normal((k, r))))
        * np.exp(1j * rng.uniform(0, 2 * np.pi, r))[None, :]  # each trial its own phase
        for _ in range(n_trials)
    ]).astype(np.complex64)
    anchor = (u @ base).astype(np.complex64)
    anchor /= np.linalg.norm(anchor, axis=0)
    modes, std = bopdmd._aggregate_modes(torch.from_numpy(u), torch.from_numpy(anchor), coefs)

    # the JAX package's materialized formula (dmd_era5_tpu/models/bopdmd.py:174-214)
    modes_t = np.einsum("sk,bkr->bsr", u.astype(np.float64), coefs).astype(np.complex64)
    inner = np.einsum("sr,bsr->br", np.conj(anchor), modes_t)
    phase = inner / np.abs(inner)
    modes_t = modes_t * np.conj(phase)[:, None, :]
    want_std = np.sqrt(np.var(modes_t.real, axis=0) + np.var(modes_t.imag, axis=0))
    mean = modes_t.mean(axis=0)
    want_modes = mean / np.linalg.norm(mean, axis=0)[None, :]
    np.testing.assert_allclose(modes.numpy(), want_modes, atol=1e-6)
    np.testing.assert_allclose(std.numpy(), want_std, rtol=1e-4, atol=1e-7)
    assert modes.dtype == torch.complex64 and std.dtype == torch.float32


@pytest.mark.parametrize("n_bad", [1, 10])
def test_diverged_trials_are_dropped(monkeypatch, n_bad):
    """Trials with non-finite eigenvalues are dropped (the survivors are
    recorded); when all diverge, both packages raise RuntimeError."""
    _, t, u, s, vt = _projected()
    for module in (bopdmd, bop_jax):
        real = module.varpro_lm_batched

        def poisoned(*args, _real=real, **kwargs):
            alpha, b, rel, n_iters = _real(*args, **kwargs)
            alpha = alpha.copy()
            alpha[:n_bad] = np.nan
            return alpha, b, rel, n_iters

        monkeypatch.setattr(module, "varpro_lm_batched", poisoned)
    args_t = [torch.from_numpy(a) for a in (u, s, vt, t)]
    args_j = [jnp.asarray(a) for a in (u, s, vt, t)]
    kw = dict(rank=4, n_trials=10, seed=2, max_iter=20)
    if n_bad == 10:
        for module, args in ((bopdmd, args_t), (bop_jax, args_j)):
            with pytest.raises(RuntimeError, match="all 10 bagging trials diverged"):
                module.bopdmd_from_svd(*args, **kw)
    else:
        res = bopdmd.bopdmd_from_svd(*args_t, **kw)
        res_j = bop_jax.bopdmd_from_svd(*args_j, **kw)
        assert len(res.trial_eigenvalues) == len(res_j.trial_eigenvalues) == 9
        assert bool(torch.isfinite(res.eigenvalues).all())


def test_bopdmd_arguments_raise():
    x, t = _oscillator_data(t_cols=40)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="trial_fraction"):
            fit_bopdmd(xt, tt, rank=4, trial_fraction=bad)
