"""The Hopper kernels against their plain PyTorch versions, on the card.

Every flag combination of ``sketch_center_gram_project`` in float32 and
bfloat16, at a ragged row count and both kernel width classes; ``gram``
at both precisions, float32 and bfloat16 input, ragged row counts and
panel widths past the JAX kernel's 1024; ``matmul`` (K6) over operand
and output dtypes and ragged M, N and K; ``householder_panel`` (K7) at
the streamed SVD's panel, the edges of its envelope and an
ill-conditioned panel, and the Householder leaf inside and outside that
envelope.  Needs a CUDA card and nvcc; elsewhere each case skips.  JAX
is not needed, so on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import itertools

import pytest
import torch

from dmd_era5_tpu_torch.ops import matmul, qr_panel
from dmd_era5_tpu_torch.ops.tsqr import _local_factor, qr_positive

M, T = 1000, 168  # M is no multiple of the kernel's 64- or 128-row tiles

CASES = [
    pytest.param(dtype, center, stats_col, scalar_stats, t_valid, emit_yc,
                 id=f"{dtype}-c{center:d}-sc{stats_col:d}-ss{scalar_stats:d}"
                    f"-tv{t_valid is not None:d}-e{emit_yc:d}")
    for dtype, center, stats_col, scalar_stats, t_valid, emit_yc in itertools.product(
        ["float32", "bfloat16"], [True, False], [False, True], [False, True],
        [None, T - 5], [True, False],
    )
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,center,stats_col,scalar_stats,t_valid,emit_yc", CASES)
def test_kernel_matches_plain_on_card(
    cuda, dtype, center, stats_col, scalar_stats, t_valid, emit_yc
):
    n = 100 if (center ^ stats_col ^ emit_yc) else 256  # 128- and 256-wide tiles
    gen = torch.Generator(device=cuda).manual_seed(7)
    tdt = getattr(torch, dtype)
    x = torch.randn((M, T), generator=gen, device=cuda) + 2.0
    if t_valid is not None:
        x[:, t_valid:] = 0.0
    x = x.to(tdt)
    w = torch.randn((T, n), generator=gen, device=cuda).to(tdt)
    flags = dict(out_dtype=tdt, center=center, stats_col=stats_col,
                 scalar_stats=scalar_stats, t_valid=t_valid, emit_yc=emit_yc)
    before = matmul.sketch_center_gram_project.launches
    got = matmul.sketch_center_gram_project(x, w, **flags)
    ref = matmul._sketch_center_gram_project_plain(x, w, **flags)
    torch.cuda.synchronize()
    assert matmul.sketch_center_gram_project.launches == before + 1
    assert (got[0] is None) == (not emit_yc)
    for name, a, b in zip(("yc", "rowsum", "rowsumsq", "G", "C"), got, ref):
        if b is None:
            continue
        a, b = a.double(), b.double()
        # f32: summation order only.  bf16: a stored Yc entry may round the
        # other way, by one ulp (2^-8 relative); the f32 stats, G and C move
        # far less (PERF.md: within 2.3e-6 of the plain version on the card
        # even at 2^19 rows, where that is the plain version's f32 error)
        rel = float((a - b).norm() / b.norm())
        limit = 2.0**-8 if (dtype == "bfloat16" and name == "yc") else 1e-5
        assert rel <= limit, (name, rel)


GRAM_CASES = [
    pytest.param(precision, dtype, m, k, id=f"{precision}-{dtype}-m{m}-k{k}")
    for precision, dtype in [("highest", "float32"), ("highest", "bfloat16"),
                             ("bf16_split", "float32")]
    for m, k in [(1000, 8), (1000, 110), (4099, 168), (1000, 1024), (300, 1030)]
]


@pytest.mark.cuda
@pytest.mark.parametrize("precision,dtype,m,k", GRAM_CASES)
def test_gram_kernel_matches_plain_on_card(cuda, precision, dtype, m, k):
    gen = torch.Generator(device=cuda).manual_seed(11)
    a = (torch.randn((m, k), generator=gen, device=cuda) + 0.5).to(getattr(torch, dtype))
    before = qr_panel.gram.launches[precision]
    got = qr_panel.gram(a, precision=precision)
    ref = qr_panel._gram_plain(a, precision)
    torch.cuda.synchronize()
    assert qr_panel.gram.launches[precision] == before + 1
    assert got.dtype == torch.float32 and got.shape == (k, k)
    assert torch.equal(got, got.T)  # mirrored from the upper blocks
    # both sum the same exact f32 products (bf16 x bf16 is exact there),
    # in another order: f32 roundoff of sums of m terms
    rel = float((got.double() - ref.double()).norm() / ref.double().norm())
    assert rel <= 1e-5, rel


@pytest.mark.cuda
@pytest.mark.parametrize("leaf,precision", [("cholqr2", "highest"),
                                            ("cholqr2_split", "bf16_split")])
def test_cholqr2_leaves_on_card(cuda, leaf, precision):
    """Both Gram passes of a CholQR2 leaf launch the kernel (the first
    pass's Q must come out row-major for the second); Q orthonormal and
    Q R == A at the single-precision level of tests/test_08_kernels.py:
    496-519, on a panel of cond ~1e3."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    u, _ = torch.linalg.qr(torch.randn((4099, 110), generator=gen, device=cuda, dtype=torch.float64))
    v, _ = torch.linalg.qr(torch.randn((110, 110), generator=gen, device=cuda, dtype=torch.float64))
    a = ((u * torch.logspace(0, -3, 110, device=cuda, dtype=torch.float64)) @ v.T).float()
    before = qr_panel.gram.launches[precision]
    q, r = getattr(qr_panel, leaf)(a)
    torch.cuda.synchronize()
    assert qr_panel.gram.launches[precision] == before + 2
    eye = torch.eye(110, dtype=torch.float64, device=cuda)
    assert float((q.double().T @ q.double() - eye).abs().max()) < 5e-6
    assert float((q.double() @ r.double() - a.double()).norm() / a.double().norm()) < 5e-6


MATMUL_CASES = [
    pytest.param(dtype, out_dtype, m, k, n, id=f"{dtype}-{out_dtype}-m{m}-k{k}-n{n}")
    for dtype in ["float32", "bfloat16"]
    for out_dtype in ["float32", "bfloat16"]
    # the streamed block's widths at a ragged row count; every edge ragged;
    # one element; a depth no 16-deep stage divides; a second column tile
    for m, k, n in [(4099, 168, 110), (130, 17, 129), (1, 1, 1), (1000, 333, 7), (64, 64, 256)]
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype,m,k,n", MATMUL_CASES)
def test_matmul_kernel_matches_plain_on_card(cuda, dtype, out_dtype, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(13)
    tdt, odt = getattr(torch, dtype), getattr(torch, out_dtype)
    x = torch.randn((m, k), generator=gen, device=cuda).to(tdt)
    w = torch.randn((k, n), generator=gen, device=cuda).to(tdt)
    before = matmul.matmul.launches
    got = matmul.matmul(x, w, out_dtype=odt)
    ref = matmul._matmul_plain(x, w, odt)
    torch.cuda.synchronize()
    assert matmul.matmul.launches == before + 1
    assert got.dtype == odt and got.shape == (m, n)
    # the same exact f32 products (bf16 x bf16 is exact there) summed in
    # another order; a bf16 output may then round the other way, by one ulp
    rel = float((got.double() - ref.double()).norm() / ref.double().norm())
    assert rel <= (2.0**-8 if out_dtype == "bfloat16" else 1e-5), rel


def _panel(kind: str, gen, dev):
    if kind == "ill":  # tests/test_08_kernels.py:258-270
        a = torch.randn((256, 16), generator=gen, device=dev)
        a[:, 0] *= 1e5
        a[:, 1] = a[:, 0] + 1e-2 * torch.randn(256, generator=gen, device=dev)
        return a
    if kind == "zero_col":
        a = torch.randn((300, 40), generator=gen, device=dev)
        a[:, 7] = 0.0
        return a
    m, n = (int(v) for v in kind.split("x"))
    return torch.randn((m, n), generator=gen, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["168x110", "8760x110", "4096x256", "64x64", "65x1", "ill", "zero_col"])
def test_householder_kernel_matches_plain_on_card(cuda, kind):
    """Q orthonormal and Q R == A as tests/test_08_kernels.py:245-270
    holds them (1e-4 and, for the ill-conditioned panel, 1e-3 and atol
    1.0), for the kernel and the plain version alike; R's entries agree
    to 1e-5 of max|R| (the same arithmetic summed in another order) and,
    on the Gaussian panels, cond < 10, Q's to 5e-5 in Frobenius norm."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    a = _panel(kind, gen, cuda)
    m, n = a.shape
    before = qr_panel.householder_panel.launches
    q, r = qr_panel.householder_panel(a)
    q_p, r_p = qr_panel._householder_plain(a)
    signs = torch.where(torch.diagonal(r_p) < 0, -1.0, 1.0)
    q_p, r_p = q_p * signs, r_p * signs[:, None]
    torch.cuda.synchronize()
    assert qr_panel.householder_panel.launches == before + 1
    assert q.shape == (m, n) and r.shape == (n, n)
    assert bool((torch.diagonal(r) >= 0).all()) and torch.equal(r, torch.triu(r))
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    a64 = a.double()
    for qq, rr in ((q, r), (q_p, r_p)):
        orth = float((qq.double().T @ qq.double() - eye).abs().max())
        if kind == "ill":
            assert orth <= 1e-3, orth
            assert torch.allclose(qq.double() @ rr.double(), a64, rtol=1e-3, atol=1.0)
        else:
            assert orth <= 1e-4, orth
            rec = float((qq.double() @ rr.double() - a64).norm() / a64.norm())
            assert rec <= 1e-5, rec
    assert float((r - r_p).abs().max()) <= 1e-5 * float(r_p.abs().max())
    if kind not in ("ill", "zero_col"):
        assert float((q.double() - q_p.double()).norm() / q_p.double().norm()) <= 5e-5


@pytest.mark.cuda
def test_householder_leaf_on_card(cuda):
    """Inside the JAX package's envelope the leaf launches K7; outside it
    (26 MB > 12 MiB) it takes the library QR, as the JAX package does."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    inside = torch.randn((168, 110), generator=gen, device=cuda)
    before = qr_panel.householder_panel.launches
    q, r = _local_factor(inside, "householder")
    q_k, r_k = qr_panel.householder_panel(inside)
    torch.cuda.synchronize()
    assert qr_panel.householder_panel.launches == before + 2
    assert torch.equal(q, q_k) and torch.equal(r, r_k)
    outside = torch.randn((20_000, 110), generator=gen, device=cuda)
    q, r = _local_factor(outside, "householder")
    q_l, r_l = qr_positive(outside)
    torch.cuda.synchronize()
    assert qr_panel.householder_panel.launches == before + 2
    assert torch.equal(r, r_l)
