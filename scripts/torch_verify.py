"""On-card verification of the PyTorch port: oracle checks and the kernels.

The counterpart of ``scripts/tpu_verify.py`` for ``dmd_era5_tpu_torch``
on a CUDA card: the same fifteen oracle checks (exact, Gram-route and
randomized SVD, the Hankel operators, optDMD, the mock-ERA5 oracle, the
fused fit step, BOP-DMD, mrDMD, DMDc), with the same numpy inputs drawn
from ``default_rng(0)`` in the same order, the same limits and names, run
through the port; then each hand-written kernel (K1-K7) against its plain
PyTorch version and f64 sums at one small shape.  Prints one PASS/FAIL
line per check (on the card with each check's kernel launches) and
``N/M checks passed``; exits non-zero on any failure.

The randomized-SVD oracle is a numpy copy of scikit-learn's
``randomized_svd`` (:func:`randomized_svd_np`), since the card's machine
has no scikit-learn.  Imports torch, numpy and scipy, and nothing of JAX.

Usage (from the repository root):
    python scripts/torch_verify.py                # on the card
    python scripts/torch_verify.py --device cpu   # the oracle checks on
        # the kernels' plain versions; the kernel checks need the card
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import NamedTuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dmd_era5_tpu_torch.ops import matmul, qr_panel  # noqa: E402
from dmd_era5_tpu_torch.ops.launches import launch_counts  # noqa: E402


class Check(NamedTuple):
    name: str
    ok: bool
    detail: str
    launches: dict | None  # kernel launches by key (K1-K7) on a card; None on the host


def randomized_svd_np(m: np.ndarray, n_components: int, n_oversamples: int = 10,
                      n_iter: int | str = "auto", random_state: int = 0):
    """``sklearn.utils.extmath.randomized_svd(m, n_components,
    random_state=random_state)`` for a dense array, step for step:
    ``n_iter='auto'`` is 7 below a tenth of the smaller side, else 4; the
    Gaussian range drawn by ``RandomState(random_state).normal`` (in m's
    dtype where m is float32), its power iterations normalized by LU
    (QR with ``n_iter <= 2`` none), the transpose of a wide m, scipy's
    gesdd, and ``svd_flip`` (u-based; v-based when transposed)."""
    from scipy import linalg

    n_random = n_components + n_oversamples
    if n_iter == "auto":
        n_iter = 7 if n_components < 0.1 * min(m.shape) else 4
    transpose = m.shape[0] < m.shape[1]
    a = m.T if transpose else m
    q = np.random.RandomState(random_state).normal(size=(a.shape[1], n_random))
    if a.dtype == np.float32:
        q = q.astype(np.float32, copy=False)
    if n_iter <= 2:
        def normalize(y):
            return y
    else:
        def normalize(y):
            return linalg.lu(y, permute_l=True, check_finite=False)[0]
    for _ in range(n_iter):
        q = normalize(a @ q)
        q = normalize(a.T @ q)
    q = linalg.qr(a @ q, mode="economic", check_finite=False)[0]
    u_hat, s, vt = linalg.svd(q.T @ a, full_matrices=False, lapack_driver="gesdd")
    u = q @ u_hat
    if not transpose:
        signs = np.sign(u[np.argmax(np.abs(u), axis=0), np.arange(u.shape[1])])
    else:
        signs = np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), axis=1)])
    u, vt = u * signs[None, :], vt * signs[:, None]
    if transpose:
        return vt[:n_components].T, s[:n_components], u[:, :n_components].T
    return u[:, :n_components], s[:n_components], vt[:n_components]


def matched_error(found: np.ndarray, true: np.ndarray) -> float:
    """max |found - true| under the one-to-one matching that makes it
    least (every permutation: a handful of eigenvalues)."""
    from itertools import permutations

    return float(min(np.abs(found[list(perm)] - true).max()
                     for perm in permutations(range(len(found)))))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def oracle_checks(device: torch.device, report) -> list[Check]:
    """``scripts/tpu_verify.py``'s fifteen checks through the port, each
    reported (``report(check)``) as it finishes."""
    from dmd_era5_tpu_torch.models import fit_optdmd
    from dmd_era5_tpu_torch.models.bopdmd import bopdmd_from_svd
    from dmd_era5_tpu_torch.models.dmdc import dmdc_rollout, fit_dmdc
    from dmd_era5_tpu_torch.models.mrdmd import fit_mrdmd, mrdmd_reconstruct
    from dmd_era5_tpu_torch.ops.hankel import hankel_exact_svd, hankel_randomized_svd
    from dmd_era5_tpu_torch.ops.svd import exact_truncated_svd, randomized_svd, truncated_svd
    from dmd_era5_tpu_torch.pipeline.train_step import fit_step_fused
    from dmd_era5_tpu_torch.snapmat import create_mock_era5_svd, delay_embed_np

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    results: list[Check] = []
    before = launch_counts()

    def check(name: str, ok: bool, detail: str = "") -> None:
        nonlocal before
        now = launch_counts()
        launched = {k: now[k] - before[k] for k in now if now[k] != before[k]}
        before = now
        results.append(Check(name, bool(ok), detail, launched if device.type == "cuda" else None))
        report(results[-1])

    rng = np.random.default_rng(0)

    # ---- exact truncated SVD vs numpy -------------------------------
    s_dim, t_dim, k = 4096, 96, 12
    a = rng.standard_normal((s_dim, 16))
    b = rng.standard_normal((16, t_dim))
    x = (a * np.logspace(0, -2, 16)) @ b + 1e-4 * rng.standard_normal((s_dim, t_dim))
    x = x.astype(np.float32)
    xt = on(x)
    res = exact_truncated_svd(xt, k)
    u_np, s_np, _ = np.linalg.svd(x, full_matrices=False)
    s_err = float(np.abs(_np(res.s) - s_np[:k]).max() / s_np[0])
    check("exact SVD singular values", s_err < 1e-3, f"rel err {s_err:.2e}")
    qa, _ = np.linalg.qr(_np(res.U))
    qb, _ = np.linalg.qr(u_np[:, :k])
    ang = 1 - np.linalg.svd(qa.T @ qb, compute_uv=False).min()
    check("exact SVD left subspace", ang < 1e-3, f"angle err {ang:.2e}")

    # ---- Gram-route exact SVD (production standard path) ------------
    res_g = truncated_svd(xt, k, svd_type="standard")
    sg_err = float(np.abs(_np(res_g.s) - s_np[:k]).max() / s_np[0])
    check("exact SVD Gram route (bf16_split)", sg_err < 1e-3, f"rel err {sg_err:.2e}")

    # ---- randomized SVD vs sklearn semantics ------------------------
    res_r = randomized_svd(xt, k, seed=0)
    u_sk, s_sk, v_sk = randomized_svd_np(x, k, random_state=0)
    rel = float(np.abs(_np(res_r.s) - s_sk).max() / s_sk[0])
    check("randomized SVD vs sklearn", rel < 1e-2, f"s rel err {rel:.2e}")
    ours = np.linalg.norm(x - _np(res_r.U) @ np.diag(_np(res_r.s)) @ _np(res_r.V))
    theirs = np.linalg.norm(x - u_sk @ np.diag(s_sk) @ v_sk)
    check("randomized SVD reconstruction", ours <= theirs * 1.05,
          f"ours {ours:.4f} vs sklearn {theirs:.4f}")

    # ---- Hankel operator path == materialized path ------------------
    d = 3
    xh = rng.standard_normal((512, 64)).astype(np.float32)
    res_op = hankel_randomized_svd(on(xh), d, 8, generator=5)
    res_mat = randomized_svd(on(delay_embed_np(xh, d)), 8, seed=5)
    herr = float(np.abs(_np(res_op.s) - _np(res_mat.s)).max())
    check("Hankel operator SVD == materialized", herr < 1e-2, f"max err {herr:.2e}")

    # ---- exact Hankel-operator SVD (banded raw-Gram path) -----------
    s_h = np.linalg.svd(delay_embed_np(xh, d).astype(np.float64), compute_uv=False)
    res_ex = hankel_exact_svd(on(xh), d, 8)
    exerr = float(np.abs(_np(res_ex.s) - s_h[:8]).max() / s_h[0])
    check("exact Hankel SVD vs materialized numpy", exerr < 1e-4, f"s rel err {exerr:.2e}")

    # ---- optDMD eigenvalue recovery ---------------------------------
    alpha_true = np.array([-0.05 + 2.1j, -0.05 - 2.1j, -0.3 + 0.7j, -0.3 - 0.7j], np.complex64)
    t = (np.arange(64) * 0.1).astype(np.float32)
    base = rng.standard_normal((256, 2)) + 1j * rng.standard_normal((256, 2))
    modes = np.stack([base[:, 0], base[:, 0].conj(), base[:, 1], base[:, 1].conj()], axis=1)
    amps = np.array([1, 1, 0.5, 0.5], np.complex64)
    xd = ((modes * amps) @ np.exp(np.outer(alpha_true, t))).real.astype(np.float32)
    fit = fit_optdmd(on(xd), on(t), rank=4)
    found = sorted(_np(fit.alpha), key=lambda z: (round(z.imag, 1), z.real))
    true_sorted = sorted(alpha_true, key=lambda z: (round(z.imag, 1), z.real))
    eig_err = max(abs(f - tv) for f, tv in zip(found, true_sorted))
    check("optDMD eigenvalue recovery", eig_err < 1e-2, f"max |err| {eig_err:.2e}")
    check("optDMD residual", float(fit.residual) < 1e-3,
          f"rel residual {float(fit.residual):.2e}")

    # ---- mock-ERA5 end-to-end oracle (north-star config 1) ----------
    _, s_m, _, _, x_m = create_mock_era5_svd(
        "2020-01-01", "2020-01-02", delay_embedding=2, n_components=10, seed=42)
    res_m = exact_truncated_svd(on(np.asarray(x_m.data, dtype=np.float32)), 10)
    merr = float(np.abs(_np(res_m.s) - s_m).max() / s_m[0])
    check("mock-ERA5 pipeline oracle", merr < 1e-3, f"s rel err {merr:.2e}")

    # ---- fused fit step loss == oracle ------------------------------
    omega = rng.standard_normal((t_dim, 22)).astype(np.float32)
    state = fit_step_fused(xt, on(omega), n_components=12)
    xc = x - x.mean(axis=1, keepdims=True)
    q_o, _ = np.linalg.qr(xc @ omega)
    s_o = np.linalg.svd(q_o.T @ xc, compute_uv=False)[:12]
    loss_o = np.sqrt(max(np.linalg.norm(xc) ** 2 - np.sum(s_o**2), 0)) / np.linalg.norm(xc)
    ferr = abs(float(state.loss) - loss_o)
    check("fused fit step loss", ferr < 1e-3, f"|delta| {ferr:.2e}")

    # ---- stats-from-sketch variant: exact row stats from K1 ---------
    st2 = fit_step_fused(xt, on(omega), n_components=12, stats_from_sketch=True)
    s2err = abs(float(st2.loss) - loss_o)
    _, rs_k, _, _, _ = matmul.sketch_center_gram_project(xt, on(omega), stats_col=True)
    rs_err = float(np.abs(_np(rs_k) - x.sum(axis=1)).max()
                   / max(np.abs(x.sum(axis=1)).max(), 1e-9))
    check("stats-from-sketch fit step", s2err < 3e-3 and rs_err < 1e-4,
          f"loss delta {s2err:.2e}, rowsum rel err {rs_err:.2e}")

    # ---- BOP-DMD: bagged trials recover the spectrum with tight std -
    alpha_b = np.array([-0.02 + 1.3j, -0.02 - 1.3j], np.complex64)
    t_b = (np.arange(128) * 0.1).astype(np.float32)
    base_b = rng.standard_normal((512, 1)) + 1j * rng.standard_normal((512, 1))
    modes_b = np.concatenate([base_b, base_b.conj()], axis=1)
    xb = (modes_b @ np.exp(np.outer(alpha_b, t_b))).real.astype(np.float32)
    xb += 0.001 * rng.standard_normal(xb.shape).astype(np.float32)
    ub, sb, vbt = np.linalg.svd(xb, full_matrices=False)
    bop = bopdmd_from_svd(on(ub[:, :4]), on(sb[:4]), on(vbt[:4]), on(t_b), rank=2,
                          n_trials=8, max_iter=30)
    freq_got = np.sort(np.abs(_np(bop.eigenvalues).imag))
    freq_err = float(np.abs(freq_got - 1.3).max())
    std_ok = float(np.abs(_np(bop.eigenvalues_std)).max())
    check("BOP-DMD bagged spectrum + trial std", freq_err < 1e-2 and std_ok < 0.05,
          f"freq err {freq_err:.2e}, max trial std {std_ok:.2e}")

    # ---- mrDMD: level residual decays on a two-scale signal ---------
    t_m = np.arange(128, dtype=np.float64)
    q_m, _ = np.linalg.qr(rng.standard_normal((256, 4)))
    xm2 = (np.outer(q_m[:, 0], np.cos(0.05 * t_m)) + np.outer(q_m[:, 1], np.sin(0.05 * t_m))
           + 0.5 * np.outer(q_m[:, 2], np.cos(1.1 * t_m))
           + 0.5 * np.outer(q_m[:, 3], np.sin(1.1 * t_m))).astype(np.float32)
    mr = fit_mrdmd(on(xm2), rank=4, max_levels=3, max_cycles=2.0)
    rec_err = float(np.linalg.norm(_np(mrdmd_reconstruct(mr) + mr.residual) - xm2[:, : mr.t_used])
                    / np.linalg.norm(xm2[:, : mr.t_used]))
    res_frac = float(np.linalg.norm(_np(mr.residual)) / np.linalg.norm(xm2))
    check("mrDMD identity + residual decay", rec_err < 1e-4 and res_frac < 0.1,
          f"identity err {rec_err:.2e}, residual frac {res_frac:.2e}")

    # ---- DMDc: forced-trajectory recovery ---------------------------
    u_true, _ = np.linalg.qr(rng.standard_normal((512, 4)))
    a0 = np.zeros((4, 4))
    for i0, (th, g) in enumerate(((0.3, 0.98), (1.1, 0.9))):
        c, s_ = np.cos(th) * g, np.sin(th) * g
        a0[2 * i0: 2 * i0 + 2, 2 * i0: 2 * i0 + 2] = [[c, -s_], [s_, c]]
    b0 = rng.standard_normal((4, 2))
    u_seq = rng.standard_normal((2, 119)).astype(np.float32)
    xdc = np.zeros((512, 120), np.float32)
    zdc = rng.standard_normal(4)
    xdc[:, 0] = u_true @ zdc
    for kk in range(119):
        zdc = a0 @ zdc + b0 @ u_seq[:, kk]
        xdc[:, kk + 1] = u_true @ zdc
    resc = fit_dmdc(on(xdc), on(u_seq), rank=4)
    # matched one to one, not by np.sort_complex: the conjugate pairs' real
    # parts are equal, so their order under sort_complex is a rounding of
    # the 7th digit, and a swapped pair reads 2 |Im| off (tpu_verify's
    # comparison; the fault of tests/test_26_mrdmd.py's R1)
    lam = _np(resc.eigenvalues).astype(np.complex128)
    lam_err = matched_error(lam, np.linalg.eigvals(a0))
    sorted_err = float(np.abs(np.sort_complex(lam) - np.sort_complex(np.linalg.eigvals(a0))).max())
    xr = _np(dmdc_rollout(resc, on(xdc[:, 0]), on(u_seq)))
    traj_err = float(np.linalg.norm(xr - xdc) / np.linalg.norm(xdc))
    check("DMDc forced-trajectory recovery", lam_err < 5e-3 and traj_err < 5e-3,
          f"eig err {lam_err:.2e} (matched; in sort_complex order {sorted_err:.2e}), "
          f"rollout err {traj_err:.2e}")
    return results


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative Frobenius error of a against b, in f64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _of_max(a: torch.Tensor, exact: torch.Tensor) -> float:
    """max|a - exact| over max|exact|, in f64."""
    return float((a.double() - exact).abs().max() / exact.abs().max().clamp_min(1e-30))


def kernel_checks(device: torch.device, report) -> list[Check]:
    """K1-K7 against their plain versions and f64 sums on the card, at
    one small shape each, with the limits ``tests/test_torch_cuda.py``
    holds them to: against the plain version 1e-5 relative (K3 2e-5 of
    max|C|); against the f64 sums K1's and K2's G and C, K3's C 1e-5 of
    their max, K4's G and K6's product 1e-6, K5's G 3e-5; K7 (one CTA:
    a 168 x 110 panel) Q orthonormal to 1e-4, Q R = A to 1e-5, R within
    1e-5 of max|R| and Q 5e-5 of the plain version."""
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, shift: float = 0.0):
        return torch.randn(shape, generator=gen, device=device) + shift

    results: list[Check] = []

    def run(name: str, body) -> None:
        before = launch_counts()
        ok, detail = body()
        torch.cuda.synchronize(device)
        now = launch_counts()
        launched = {k: now[k] - before[k] for k in now if now[k] != before[k]}
        results.append(Check(name, bool(ok), detail, launched))
        report(results[-1])

    x, w = randn(20_000, 168, shift=2.0), randn(168, 128)

    def k1():
        got = matmul.sketch_center_gram_project(x, w)
        ref = matmul._sketch_center_gram_project_plain(x, w)
        plain = max(_rel(a, b) for a, b in zip(got, ref))
        yc = got[0].double()
        f64 = max(_of_max(got[3], yc.T @ yc), _of_max(got[4], yc.T @ x.double()))
        return plain <= 1e-5 and f64 <= 1e-5, f"vs plain {plain:.2e}, G and C vs f64 {f64:.2e}"

    def k2():
        got = matmul.sketch_center_gram(x, w)
        ref = matmul._sketch_center_gram_plain(x, w)
        plain = max(_rel(a, b) for a, b in zip(got[:3], ref[:3]))
        yc = got[0].double()
        f64 = _of_max(got[3], yc.T @ yc)
        return plain <= 1e-5 and f64 <= 1e-5, f"vs plain {plain:.2e}, G vs f64 {f64:.2e}"

    y = randn(20_000, 100)

    def k3():
        c = matmul.project(x, y)
        exact = y.double().T @ x.double()
        f64, plain = _of_max(c, exact), _of_max(c, matmul._project_plain(x, y).double())
        return f64 <= 1e-5 and plain <= 2e-5, f"C vs f64 {f64:.2e}, vs plain {plain:.2e}"

    a = randn(20_000, 110, shift=0.5)
    a_exact = a.double().T @ a.double()

    def gram(precision: str, f64_limit: float):
        def body():
            g = qr_panel.gram(a, precision)
            plain = _rel(g, qr_panel._gram_plain(a, precision))
            f64 = _of_max(g, a_exact)
            ok = plain <= 1e-5 and f64 <= f64_limit and torch.equal(g, g.T)
            return ok, f"vs plain {plain:.2e}, vs f64 {f64:.2e}, symmetric {torch.equal(g, g.T)}"
        return body

    w6 = randn(168, 110)

    def k6():
        out = matmul.matmul(x, w6)
        plain = _rel(out, matmul._matmul_plain(x, w6, torch.float32))
        f64 = _of_max(out, x.double() @ w6.double())
        return plain <= 1e-5 and f64 <= 1e-6, f"vs plain {plain:.2e}, vs f64 {f64:.2e}"

    panel = randn(168, 110)

    def k7():
        sms, smem = qr_panel._householder_limits(panel.device)
        ctas = len(qr_panel.householder_shares(*panel.shape, sms, smem))
        q, r = qr_panel.householder_panel(panel)
        q_p, r_p = qr_panel._householder_plain(panel)
        signs = torch.where(torch.diagonal(r_p) < 0, -1.0, 1.0)
        q_p, r_p = q_p * signs, r_p * signs[:, None]
        eye = torch.eye(panel.shape[1], dtype=torch.float64, device=device)
        orth = float((q.double().T @ q.double() - eye).abs().max())
        rec = _rel(q.double() @ r.double(), panel.double())
        r_err = _of_max(r, r_p.double())
        q_err = _rel(q, q_p)
        ok = (ctas == 1 and bool((torch.diagonal(r) >= 0).all()) and orth <= 1e-4
              and rec <= 1e-5 and r_err <= 1e-5 and q_err <= 5e-5)
        return ok, (f"P {ctas}, orth {orth:.2e}, QR - A {rec:.2e}, R vs plain {r_err:.2e}, "
                    f"Q vs plain {q_err:.2e}")

    run("K1 sketch_center_gram_project vs plain and f64 (20000 x 168, N 128)", k1)
    run("K2 sketch_center_gram vs plain and f64 (20000 x 168, N 128)", k2)
    run("K3 project vs plain and f64 (20000 x 168, N 100)", k3)
    run("K4 gram highest vs plain and f64 (20000 x 110)", gram("highest", 1e-6))
    run("K5 gram bf16_split vs plain and f64 (20000 x 110)", gram("bf16_split", 3e-5))
    run("K6 matmul vs plain and f64 (20000 x 168 @ 168 x 110)", k6)
    run("K7 householder_panel vs plain and f64 (168 x 110, one CTA)", k7)
    return results


N_KERNEL_CHECKS = 7


def print_check(c: Check) -> None:
    tail = ""
    if c.launches is not None:
        tail = "  [launches " + (", ".join(f"{k} {n}" for k, n in c.launches.items()) or "none") + "]"
    print(f"{'PASS' if c.ok else 'FAIL'}  {c.name}  {c.detail}{tail}", flush=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' runs the oracle checks on the host (default: the card)")
    args = parser.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("no CUDA card: pass --device cpu to run the oracle checks on the host",
              file=sys.stderr)
        return 2
    device = torch.device(args.device or "cuda")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU"
    print(f"device: {device.type} {name}", flush=True)
    if device.type == "cuda":  # library f32 products in full f32, as the plain versions assume
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    results = oracle_checks(device, print_check)
    if device.type == "cuda":
        results += kernel_checks(device, print_check)
    n_fail = sum(not c.ok for c in results)
    print(f"\n{len(results) - n_fail}/{len(results)} checks passed")
    if device.type != "cuda":
        print(f"{N_KERNEL_CHECKS} kernel checks not run: they need a CUDA card")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
