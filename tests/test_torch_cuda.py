"""The Hopper kernels against their plain PyTorch versions, on the card.

Every flag combination of ``sketch_center_gram_project`` (K1) in float32
and bfloat16, at a ragged row count, at the week's T and past W's resident
depth, on both sides of the sketch stage's 112-wide CTA columns, and
against one TF32 pass; the
two-pass fallback, ``sketch_center_gram`` (K2) and ``project`` (K3), over
operand and output dtypes at ragged M, T and N up to 512 (on both sides
of K3's 128-wide tensor-core blocks), K3 against one TF32 pass, and its
route through ``sketch_center_gram_project``; ``gram`` at both
precisions, float32 and bfloat16 input, ragged row counts and panel
widths on both sides of K4's and K5's block edges and past the JAX
kernel's 1024, K4 against one TF32 pass; ``matmul`` (K6) over operand
and output dtypes, ragged M, N and K on both sides of its tile, column
and MMA-depth edges and past its resident depth of w, and against one
TF32 pass; ``householder_panel`` (K7) at
the streamed SVD's panel, the edges of its envelope and an
ill-conditioned panel, on its own choice of CTAs and on forced ones
(shares shorter than n, row j's holder at share edges, a zero column in
a late share, m no multiple of the CTAs), past its capacity, and the
Householder leaf inside and outside that envelope.  Needs a CUDA card and nvcc; elsewhere each case skips.  JAX
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
    n = 100 if (center ^ stats_col ^ emit_yc) else 256  # one and three 112-wide CTA columns
    _check_k1(cuda, dtype, T, n, center, stats_col, scalar_stats, t_valid, emit_yc)


# K1 past W's resident depth (176 rows of K in f32, 704 in bf16 at 128
# columns a CTA, 168 and 672 at 112: walked in panels), at widths on both
# sides of the sketch stage's CTA columns (112 or 128 wide, whichever pads
# less) and at the widest, over every flag combination
PANEL_CASES = [
    pytest.param(dtype, t, n, center, stats_col, scalar_stats, t_valid, emit_yc,
                 id=f"{dtype}-t{t}-n{n}-c{center:d}-sc{stats_col:d}-ss{scalar_stats:d}"
                    f"-tv{t_valid:d}-e{emit_yc:d}")
    for dtype, t in [("float32", 300), ("bfloat16", 700)]
    # 168: G on 64-wide blocks in f32 (K4's table)
    for n in [100, 112, 113, 128, 129, 168, 224, 225, 256]
    for center, stats_col, scalar_stats, t_valid, emit_yc in itertools.product(
        [True, False], [False, True], [False, True], [False, True], [True, False])
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t,n,center,stats_col,scalar_stats,t_valid,emit_yc", PANEL_CASES)
def test_kernel_past_the_resident_panel_on_card(
    cuda, dtype, t, n, center, stats_col, scalar_stats, t_valid, emit_yc
):
    _check_k1(cuda, dtype, t, n, center, stats_col, scalar_stats, t - 5 if t_valid else None,
              emit_yc)


def _check_k1(cuda, dtype, t, n, center, stats_col, scalar_stats, t_valid, emit_yc):
    """K1 against its plain version at M rows (no multiple of 128), T = t."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    tdt = getattr(torch, dtype)
    x = torch.randn((M, t), generator=gen, device=cuda) + 2.0
    if t_valid is not None:
        x[:, t_valid:] = 0.0
    x = x.to(tdt)
    w = torch.randn((t, n), generator=gen, device=cuda).to(tdt)
    flags = dict(out_dtype=tdt, center=center, stats_col=stats_col,
                 scalar_stats=scalar_stats, t_valid=t_valid, emit_yc=emit_yc)
    before = matmul.sketch_center_gram_project.launches
    got = matmul.sketch_center_gram_project(x, w, **flags)
    ref = matmul._sketch_center_gram_project_plain(x, w, **flags)
    torch.cuda.synchronize()
    assert matmul.sketch_center_gram_project.launches == before + 1
    assert (got[0] is None) == (not emit_yc)
    if dtype == "bfloat16":
        # G and C come from the STORED Yc, and two summation orders of Y
        # round a few of its entries the other way, one ulp each (held
        # below): ~1e-4 of them move G and C by ~1.7e-5 at these M rows.  So
        # the plain products are taken of the kernel's own stored Yc, which
        # K1 gives bit for bit again with emit_yc, and the share of Yc's
        # entries that differ from the plain version's is held to 4e-3: at
        # most 1.6e-4 at T 168 and 1.03e-3 at T 700 over these cases, about
        # half of them rounded up (scripts/torch_k1_flips.py); an epilogue
        # that truncated its rounding differs in about half of all entries
        again = matmul.sketch_center_gram_project(x, w, **{**flags, "emit_yc": True})
        assert torch.equal(again[3], got[3]) and torch.equal(again[4], got[4])
        yc_plain = matmul._sketch_center_gram_project_plain(x, w, **{**flags, "emit_yc": True})[0]
        flips = float((again[0] != yc_plain).double().mean())
        assert flips <= 4e-3, ("yc entries differing", flips)
        ycf = again[0].float()
        ref = (*ref[:3], ycf.T @ ycf, ycf.T @ x.float())
    for name, a, b in zip(("yc", "rowsum", "rowsumsq", "G", "C"), got, ref):
        if b is None:
            continue
        a, b = a.double(), b.double()
        # f32: summation order only.  bf16: a stored Yc entry may round the
        # other way, by one ulp (2^-8 relative); the f32 stats move far less
        rel = float((a - b).norm() / b.norm())
        limit = 2.0**-8 if (dtype == "bfloat16" and name == "yc") else 1e-5
        assert rel <= limit, (name, rel)


GRAM_CASES = [
    pytest.param(precision, dtype, m, k, id=f"{precision}-{dtype}-m{m}-k{k}")
    for precision, dtype in [("highest", "float32"), ("highest", "bfloat16"),
                             ("bf16_split", "float32")]
    # K5's blocks are 64 wide up to K = 256, 128 past it, K4's (f32) 64 wide
    # for 128 < K <= 192, 128 elsewhere: widths on both sides of each edge,
    # one column, M no multiple of a 16-row slab
    for m, k in [(1000, 8), (1000, 110), (4099, 168), (1000, 1024), (300, 1030), (1001, 1),
                 (777, 65), (1000, 256), (1001, 257), (133, 300), (1000, 129), (1000, 193)]
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
    for m, k, n in [(4099, 168, 110), (130, 17, 129), (1, 1, 1), (1000, 333, 7), (64, 64, 256),
                    # both sides of the 64-row warpgroup and 128-row tile
                    # edges, the 112-wide CTA column and the 8- and 16-deep
                    # MMA steps; w past the resident depth (168 < K), in
                    # panels, with unaligned (169, 1,030) and aligned
                    # (1,024) rows; past both at once
                    (63, 8, 8), (64, 16, 112), (65, 24, 113), (127, 168, 256), (129, 169, 257),
                    (300, 1030, 110), (65, 1024, 257),
                    # several row tiles a persistent CTA, in one and in
                    # three CTA columns
                    (40_000, 168, 110), (20_000, 168, 257)]
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
    # f32-faithful products on both sides (3xTF32 on the card against full
    # f32; bf16 x bf16 products are exact in f32) summed in another order;
    # a bf16 output may then round the other way, by one ulp
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
    if kind == "bf16":  # widened to f32 before the kernel, as the plain version does
        return torch.randn((168, 110), generator=gen, device=dev).bfloat16()
    if kind == "zero_col_late":  # 20 CTAs of 10 rows: column 117's row is in the 12th
        a = torch.randn((200, 120), generator=gen, device=dev)
        a[:, 117] = 0.0
        return a
    m, n = (int(v) for v in kind.split("x"))
    return torch.randn((m, n), generator=gen, device=dev)


# (panel, CTAs): None takes householder_panel's own choice; a number forces
# that many CTAs through the wrapper's launch (counted all the same)
HOUSEHOLDER_CASES = [
    pytest.param(kind, None, id=kind)
    for kind in ["168x110", "8760x110", "4096x256", "64x64", "65x1", "ill", "zero_col", "bf16"]
] + [
    pytest.param("1000x200", 132, id="p132-shares-shorter-than-n"),
    pytest.param("256x128", 4, id="p4-row-holder-at-share-edges"),
    pytest.param("zero_col_late", 20, id="p20-zero-column-in-a-late-share"),
    pytest.param("1003x50", 7, id="p7-m-not-a-multiple"),
    pytest.param("168x110", 3, id="p3-week-iterate"),
    pytest.param("64x64", 64, id="p64-one-row-a-cta"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,ctas", HOUSEHOLDER_CASES)
def test_householder_kernel_matches_plain_on_card(cuda, kind, ctas):
    """Q orthonormal and Q R == A as tests/test_08_kernels.py:245-270
    holds them (1e-4 and, for the ill-conditioned panel, 1e-3 and atol
    1.0), for the kernel and the plain version alike; R's entries agree
    to 1e-5 of max|R| (the same arithmetic summed in another order) and,
    on the Gaussian panels, cond < 10, Q's to 5e-5 in Frobenius norm.
    Forced CTA counts put shares shorter than n, row j's holder at share
    edges, a zero column whose row lies in a late share and a ragged last
    share on the card."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    a = _panel(kind, gen, cuda)
    m, n = a.shape
    before = qr_panel.householder_panel.launches
    if ctas is None:
        q, r = qr_panel.householder_panel(a)
    else:
        q, r = qr_panel._householder_launch(a, ctas)
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
    if kind.startswith("zero_col"):
        zc = 7 if kind == "zero_col" else 117
        assert float(r[zc, zc]) == 0.0
    elif kind != "ill":
        assert float((q.double() - q_p.double()).norm() / q_p.double().norm()) <= 5e-5


@pytest.mark.cuda
def test_householder_kernel_capacity_on_card(cuda):
    """A panel past what one CTA an SM holds in shared memory raises
    ValueError, naming the limit, and launches nothing."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, smem = qr_panel._householder_limits(cuda)
    rows = qr_panel._householder_rows_cap(256, smem)
    before = qr_panel.householder_panel.launches
    with pytest.raises(ValueError, match="rows a CTA"):
        qr_panel.householder_panel(torch.zeros((rows * sms + 1, 256), device=cuda))
    assert qr_panel.householder_panel.launches == before
    q, r = qr_panel.householder_panel(torch.randn((rows * sms, 256), device=cuda))
    torch.cuda.synchronize()
    assert qr_panel.householder_panel.launches == before + 1
    assert bool(torch.isfinite(q).all()) and bool((torch.diagonal(r) >= 0).all())


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


SCG_CASES = [
    pytest.param(dtype, out_dtype, center, m, t, n,
                 id=f"{dtype}-{out_dtype}-c{center:d}-m{m}-t{t}-n{n}")
    for dtype, out_dtype in [("float32", "float32"), ("bfloat16", "bfloat16"),
                             ("bfloat16", "float32"), ("float32", "bfloat16")]
    # ragged every way; K1's widest; past it (d = 3 at k = 100); d = 4; one element
    for m, t, n, center in [(1000, 168, 100, True), (1031, 333, 256, False),
                            (777, 8760, 257, True), (300, 50, 384, True),
                            (129, 40, 512, False), (1, 1, 1, True)]
]


def _f64_close(got, exact, what, rel=1e-5):
    """Within ``rel`` of the largest entry of the f64 sums."""
    err = float((got.double() - exact).abs().max())
    scale = float(exact.abs().max())
    assert err <= rel * max(scale, 1e-30), (what, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype,center,m,t,n", SCG_CASES)
def test_sketch_center_gram_kernel_matches_plain_on_card(cuda, dtype, out_dtype, center, m, t, n):
    """K2: Yc within f32 roundoff of the plain version (one bf16 ulp for
    a bf16 Yc, which may round the other way), the row statistics within
    1e-5, and G exactly symmetric and within 1e-5 max|G| of the f64 sums
    of the kernel's own stored Yc (the plain version sums it in f32)."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    tdt, odt = getattr(torch, dtype), getattr(torch, out_dtype)
    x = (torch.randn((m, t), generator=gen, device=cuda) + 1.0).to(tdt)
    w = torch.randn((t, n), generator=gen, device=cuda).to(tdt)
    before = matmul.sketch_center_gram.launches
    got = matmul.sketch_center_gram(x, w, out_dtype=odt, center=center)
    ref = matmul._sketch_center_gram_plain(x, w, odt, center)
    torch.cuda.synchronize()
    assert matmul.sketch_center_gram.launches == before + 1
    yc, rs, ss, g = got
    assert yc.dtype == odt and yc.shape == (m, n) and g.shape == (n, n)
    assert torch.equal(g, g.T)
    for name, a, b in zip(("yc", "rowsum", "rowsumsq"), got, ref):
        a, b = a.double(), b.double()
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        limit = 2.0**-8 if (name == "yc" and out_dtype == "bfloat16") else 1e-5
        assert rel <= limit, (name, rel)
    ycd = yc.double()
    _f64_close(g, ycd.T @ ycd, "G")


PROJECT_CASES = [
    pytest.param(y_dtype, x_dtype, m, t, n, id=f"y{y_dtype}-x{x_dtype}-m{m}-t{t}-n{n}")
    for y_dtype, x_dtype in [("float32", "float32"), ("bfloat16", "bfloat16"),
                             ("bfloat16", "float32"), ("float32", "bfloat16")]
    # K3's 128 x 128 blocks of C and 16- or 32-row slabs: N and T on no
    # multiple of 8, 16 or 128, N = 1, T = 1, both past 256 at once, and
    # the d = 3 pass's aligned widths (16-byte copies)
    for m, t, n in [(1000, 168, 100), (1031, 8760, 256), (300, 50, 384), (129, 65, 512),
                    (1, 1, 1), (1037, 133, 77), (257, 130, 1), (300, 1, 129), (515, 300, 260),
                    (1000, 168, 384)]
]


@pytest.mark.cuda
@pytest.mark.parametrize("y_dtype,x_dtype,m,t,n", PROJECT_CASES)
def test_project_kernel_matches_plain_on_card(cuda, y_dtype, x_dtype, m, t, n):
    """K3: C within 1e-5 max|C| of the f64 sums of Y^T X, and of the plain
    version (which sums in f32)."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    x = torch.randn((m, t), generator=gen, device=cuda).to(getattr(torch, x_dtype))
    y = torch.randn((m, n), generator=gen, device=cuda).to(getattr(torch, y_dtype))
    before = matmul.project.launches
    c = matmul.project(x, y)
    ref = matmul._project_plain(x, y)
    torch.cuda.synchronize()
    assert matmul.project.launches == before + 1
    assert c.dtype == torch.float32 and c.shape == (n, t)
    exact = y.double().T @ x.double()
    _f64_close(c, exact, "C")
    _f64_close(c, ref.double(), "C vs plain", rel=2e-5)


@pytest.mark.cuda
def test_project_is_not_one_tf32_pass_on_card(cuda):
    """K3's 3xTF32 products on f32 operands whose entries span six decades:
    C within 1e-6 max|C| of the f64 sums, a limit that one TF32 pass (the
    library product with TF32 allowed, ~2^-11 a product) misses."""
    gen = torch.Generator(device=cuda).manual_seed(37)

    def wide(shape):
        mag = 10.0 ** (6 * torch.rand(shape, generator=gen, device=cuda) - 3)
        return torch.randn(shape, generator=gen, device=cuda) * mag

    x, y = wide((20_000, 168)), wide((20_000, 100))
    exact = y.double().T @ x.double()
    scale = float(exact.abs().max())
    c = matmul.project(x, y)
    err = float((c.double() - exact).abs().max()) / scale
    assert err <= 1e-6, err
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        one_pass = float(((y.T @ x).double() - exact).abs().max()) / scale
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert one_pass > 1e-6, one_pass


@pytest.mark.cuda
def test_matmul_is_not_one_tf32_pass_on_card(cuda):
    """K6's 3xTF32 products on f32 operands whose entries span six decades
    (the streamed block's K and N): out within 1e-6 max|out| of the f64
    product, a limit that one TF32 pass (the library product with TF32
    allowed, ~2^-11 a product) misses."""
    gen = torch.Generator(device=cuda).manual_seed(41)

    def wide(shape):
        mag = 10.0 ** (6 * torch.rand(shape, generator=gen, device=cuda) - 3)
        return torch.randn(shape, generator=gen, device=cuda) * mag

    x, w = wide((20_000, 168)), wide((168, 110))
    exact = x.double() @ w.double()
    scale = float(exact.abs().max())
    out = matmul.matmul(x, w)
    err = float((out.double() - exact).abs().max()) / scale
    assert err <= 1e-6, err
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        one_pass = float(((x @ w).double() - exact).abs().max()) / scale
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert one_pass > 1e-6, one_pass


def _wide(shape, gen, dev):
    """Gaussian entries scaled by magnitudes spread over six decades."""
    mag = 10.0 ** (6 * torch.rand(shape, generator=gen, device=dev) - 3)
    return torch.randn(shape, generator=gen, device=dev) * mag


def _one_tf32_pass_err(fn, exact) -> float:
    """max|fn() - exact| / max|exact| with TF32 allowed for the library
    product inside fn, the flag restored."""
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got = fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return float((got.double() - exact).abs().max()) / float(exact.abs().max())


@pytest.mark.cuda
def test_sketch_center_gram_project_is_not_one_tf32_pass_on_card(cuda):
    """K1's three stages on f32 operands whose entries span six decades (the
    week's T, the fit step's sketch width): Yc within 1e-6 max|Yc| of the
    f64 product X W (no centring), G and C within 1e-6 of the f64 sums of
    the stored Yc, limits that one TF32 pass of each product misses."""
    gen = torch.Generator(device=cuda).manual_seed(43)
    x, w = _wide((20_000, 168), gen, cuda), _wide((168, 128), gen, cuda)
    yc, _, _, g, c = matmul.sketch_center_gram_project(x, w, center=False)
    y64 = yc.double()
    exact = {"Yc": x.double() @ w.double(), "G": y64.T @ y64, "C": y64.T @ x.double()}
    for name, got in (("Yc", yc), ("G", g), ("C", c)):
        err = float((got.double() - exact[name]).abs().max()) / float(exact[name].abs().max())
        assert err <= 1e-6, (name, err)
    one_pass = {"Yc": lambda: x @ w, "G": lambda: yc.T @ yc, "C": lambda: yc.T @ x}
    for name, fn in one_pass.items():
        err = _one_tf32_pass_err(fn, exact[name])
        assert err > 1e-6, (name, err)


@pytest.mark.cuda
def test_gram_is_not_one_tf32_pass_on_card(cuda):
    """K4's 3xTF32 products on f32 A whose entries span six decades (the
    week's K): G within 1e-6 max|G| of the f64 sums, exactly symmetric, a
    limit that one TF32 pass misses."""
    gen = torch.Generator(device=cuda).manual_seed(47)
    a = _wide((20_000, 168), gen, cuda)
    exact = a.double().T @ a.double()
    g = qr_panel.gram(a)
    assert torch.equal(g, g.T)
    err = float((g.double() - exact).abs().max()) / float(exact.abs().max())
    assert err <= 1e-6, err
    assert _one_tf32_pass_err(lambda: a.T @ a, exact) > 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,launches", [(168, 256, (1, 0, 0)), (168, 384, (0, 1, 1)),
                                          (8760, 128, (0, 1, 1))])
def test_fused_entry_routes_on_card(cuda, t, n, launches):
    """sketch_center_gram_project launches K1 where it can, else K2 and K3
    once each (a sketch past N_MAX, a time axis past the JAX package's
    fused range), and agrees with its plain route."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randn((700, t), generator=gen, device=cuda)
    w = torch.randn((t, n), generator=gen, device=cuda)
    before = (matmul.sketch_center_gram_project.launches, matmul.sketch_center_gram.launches,
              matmul.project.launches)
    got = matmul.sketch_center_gram_project(x, w, scalar_stats=True)
    torch.cuda.synchronize()
    after = (matmul.sketch_center_gram_project.launches, matmul.sketch_center_gram.launches,
             matmul.project.launches)
    assert tuple(a - b for a, b in zip(after, before)) == launches
    ref = matmul.sketch_center_gram_project(x.cpu(), w.cpu(), scalar_stats=True)
    for name, a, b in zip(("yc", "rs2", "ss", "G", "C"), got, ref):
        a, b = a.double().cpu(), b.double()
        assert float((a - b).norm() / b.norm()) <= 1e-5, name
