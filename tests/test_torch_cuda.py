"""The Hopper kernels against their plain PyTorch versions, on the card.

Every flag combination of ``sketch_center_gram_project`` (K1) in float32
and bfloat16, at a ragged row count, at the week's T and past W's resident
depth, on both sides of the sketch stage's 112-wide CTA columns, and
against one TF32 pass; the
two-pass fallback, ``sketch_center_gram`` (K2: K1's sketch and G stages)
and ``project`` (K3), over operand and output dtypes at ragged M, T and N
up to 2048 (at the edges of K3's block rule in both orientations, of W's
resident depth in K2's sketch, on rows not 16-byte aligned and on views
whose base is not), K3 twice bit for bit, K2 and K3 against one TF32
pass, and their route through
``sketch_center_gram_project``; ``gram`` at both
precisions, float32 and bfloat16 input, ragged row counts and panel
widths on both sides of K4's and K5's block edges, K5's rows by TMA and
through registers (K % 4, an unaligned base), and past the JAX kernel's
1024, K4 against one TF32 pass, K5 against one bf16 pass, two calls bit
for bit at both precisions; ``matmul`` (K6) over operand
and output dtypes, ragged M, N and K on both sides of its tile, column
and MMA-depth edges and past its resident depth of w, at the narrow
columns (24, 40, 80) on rows 16-byte aligned and not (whole tiles by bulk
copies, a last tile whose span is no multiple of 16 bytes), on an x whose
base is not 16-byte aligned, and against one TF32 pass at the streamed
block and at a narrow width; K1 at those widths and at the bench's bf16
shape; ``householder_panel`` (K7) at
the streamed SVD's panel, the edges of its envelope and an
ill-conditioned panel, on its own choice of CTAs and on forced ones
(shares shorter than n, row j's holder at share edges, a zero column in
a late share, m no multiple of the CTAs), past its capacity, and the
Householder leaf inside and outside that envelope; the DMD models' use
of the kernels: K4 at the streamed mrDMD refit's block and at mrDMD
windows copied from a residual's column blocks (against the f64 sums
and one TF32 pass), ``fit_mrdmd`` (K4 once a window) and
``fit_mrdmd_streamed`` (once a block), DMDc (K4 and K1 twice) and the
ensemble (K1 once a member) against their CPU runs; K3 with the one-pass
sketch's +-1 panel generated on the card, the streamed passes' pinned
ring under a slow reader, and the one-pass SVD and the rank update
against their CPU runs; CholQR's whitening solve in row blocks against
one solve, and the unfused Hankel operators and their randomized SVD
(K6, K3 and the split CholQR2 leaf's K5) against their CPU runs.  Needs
a CUDA card and nvcc; elsewhere each case skips.  JAX
is not needed, so on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import itertools

import numpy as np
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


# K1's sketch at the narrow widths and unaligned rows of its tile table
# (config 2's T 97 at N 76: 80 columns a CTA, whole tiles by bulk copies;
# T 98 = 2 mod 4 at N 40; T 100 at N 24, aligned; bf16 at T 97, element by
# element) and at the bench's T 512, N 128 in bf16 (its k-steps two in
# flight), at a row count whose last tile's span is no multiple of 16 bytes
NARROW_CASES = [
    pytest.param(dtype, t, n, center, stats_col, scalar_stats, emit_yc,
                 id=f"{dtype}-t{t}-n{n}-c{center:d}-sc{stats_col:d}-ss{scalar_stats:d}"
                    f"-e{emit_yc:d}")
    for dtype, t, n in [("float32", 97, 76), ("float32", 98, 40), ("float32", 100, 24),
                        ("bfloat16", 97, 76), ("bfloat16", 512, 128)]
    for center, stats_col, scalar_stats, emit_yc in [(True, False, True, True),
                                                     (False, False, False, True),
                                                     (True, True, False, False)]
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t,n,center,stats_col,scalar_stats,emit_yc", NARROW_CASES)
def test_kernel_at_narrow_widths_on_card(cuda, dtype, t, n, center, stats_col, scalar_stats,
                                         emit_yc):
    _check_k1(cuda, dtype, t, n, center, stats_col, scalar_stats, None, emit_yc, m=1001)


def _check_k1(cuda, dtype, t, n, center, stats_col, scalar_stats, t_valid, emit_yc, m=M):
    """K1 against its plain version at m rows (no multiple of 128), T = t."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    tdt = getattr(torch, dtype)
    x = torch.randn((m, t), generator=gen, device=cuda) + 2.0
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
    # K5's blocks are 64 wide up to K = 64, 128 past it (gram.cu's table),
    # its rows by TMA where K % 4 == 0 and through registers elsewhere (110
    # beside 112, 97, 257, 1030); K4's (f32) 64 wide for 128 < K <= 192, 128
    # elsewhere: widths on both sides of each edge, one column, M no
    # multiple of a 16-row slab, K past the JAX kernel's 1024
    for m, k in [(1000, 8), (1000, 110), (4099, 168), (1000, 1024), (300, 1030), (1001, 1),
                 (777, 65), (1000, 256), (1001, 257), (133, 300), (1000, 129), (1000, 193),
                 (1000, 112), (1003, 97), (1000, 64), (999, 60), (1000, 128), (4097, 1028)]
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
@pytest.mark.parametrize("m,k", [(1000, 112), (1000, 168), (4097, 300)])
def test_gram_split_on_unaligned_base_on_card(cuda, m, k):
    """K5 on rows whose stride is 16-byte aligned but whose base is not
    (a view one entry into its storage): the register-staged loads, one
    entry at a time, against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    a = (torch.randn(m * k + 1, generator=gen, device=cuda) + 0.5)[1:].view(m, k)
    got = qr_panel.gram(a, "bf16_split")
    ref = qr_panel._gram_plain(a, "bf16_split")
    assert torch.equal(got, got.T)
    rel = float((got.double() - ref.double()).norm() / ref.double().norm())
    assert rel <= 1e-5, rel


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16_split"])
@pytest.mark.parametrize("m,k", [(70_000, 110), (70_000, 112), (20_000, 300)])
def test_gram_run_to_run_identity_on_card(cuda, precision, m, k):
    """Two calls give G bit for bit (row shares summed in a fixed order, no
    atomics), by TMA (K % 4 == 0) and through registers."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    a = torch.randn((m, k), generator=gen, device=cuda)
    first = qr_panel.gram(a, precision)
    assert torch.equal(first, qr_panel.gram(a, precision))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(200_000, 64), (200_000, 110), (20_000, 300)])
def test_gram_split_is_not_one_bf16_pass_on_card(cuda, m, k):
    """K5 within 3e-5 max|G| of the f64 sums (chip_smoke's limit) on
    columns of 1/3 + 1e-4 noise: every entry rounds to the same bf16
    value, so one bf16 pass (bf16(A)^T bf16(A) summed in f64) errs
    coherently, by ~4e-3 of max|G|, and misses the limit; the split's L
    carries that rounding and its own errors average out."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    a = 1.0 / 3.0 + 1e-4 * torch.randn((m, k), generator=gen, device=cuda)
    exact = a.double().T @ a.double()
    scale = float(exact.abs().max())
    g = qr_panel.gram(a, "bf16_split")
    assert torch.equal(g, g.T)
    err = float((g.double() - exact).abs().max()) / scale
    assert err <= 3e-5, err
    h = a.bfloat16().double()
    one_pass = float((h.T @ h - exact).abs().max()) / scale
    assert one_pass > 3e-5, one_pass


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
                    (40_000, 168, 110), (20_000, 168, 257),
                    # the narrow columns (24, 40, 80) on rows 16-byte aligned
                    # (K 100) and not (K 97 odd, K 98 = 2 mod 4: whole tiles
                    # by bulk copies in f32), a last tile whose span is no
                    # multiple of 16 bytes (105 x 97 x 4), less than a tile,
                    # and several tiles a CTA
                    (1001, 97, 20), (4099, 97, 40), (1000, 98, 24), (4099, 100, 24),
                    (1001, 97, 76), (65, 99, 20), (40_000, 97, 40)]
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(97, 40), (100, 24), (168, 110)])
def test_matmul_unaligned_base_on_card(cuda, dtype, k, n):
    """x whose first element is one element past a 16-byte boundary: the
    element-wise copy path at any row width."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    tdt = getattr(torch, dtype)
    m = 1001
    x = torch.randn(m * k + 1, generator=gen, device=cuda).to(tdt)[1:].view(m, k)
    w = torch.randn((k, n), generator=gen, device=cuda).to(tdt)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert matmul.matmul_block(m, k, n, tdt, base_aligned=False).load == "elem"
    got = matmul.matmul(x, w)
    ref = matmul._matmul_plain(x, w, torch.float32)
    torch.cuda.synchronize()
    rel = float((got.double() - ref.double()).norm() / ref.double().norm())
    assert rel <= 1e-5, rel


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
    # ragged every way; K1's widest; past it (d = 3 at k = 100); d = 4; one
    # element; T past W's resident depth in the sketch (176 rows of K in
    # f32, 704 in bf16, at 128 columns a CTA: walked in panels) up to the
    # hourly year, centred and not; rows not 16-byte aligned (T % 4 in f32,
    # T % 8 in bf16: the element-wise instantiation) at the d = 3 width; the
    # widest sketch, SKETCH_N_MAX
    for m, t, n, center in [(1000, 168, 100, True), (1031, 333, 256, False),
                            (777, 8760, 257, True), (300, 50, 384, True),
                            (129, 40, 512, False), (1, 1, 1, True),
                            (1000, 705, 128, False), (1000, 705, 384, True),
                            (1000, 8760, 128, False), (1000, 167, 384, False),
                            (300, 168, 2048, True)]
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
    of the kernel's own stored Yc (the plain version sums it in f32).  A
    bf16 Yc is held as K1's is: the share of its entries that differ from
    the plain version's to 4e-3, and G to the plain product of the
    kernel's own stored Yc within 1e-5."""
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
        den = b.norm()
        if name == "yc" and float(den) == 0.0:
            # one centred time step: the plain Yc is exactly 0, and the
            # 3xTF32 product rounds x w otherwise than the f32 product, so
            # Yc is read against the scale of its terms, sum_t |x| |w|
            den = (x.double().abs() @ w.double().abs()).norm()
        rel = float((a - b).norm() / den.clamp_min(1e-30))
        limit = 2.0**-8 if (name == "yc" and out_dtype == "bfloat16") else 1e-5
        assert rel <= limit, (name, rel)
    ycd = yc.double()
    _f64_close(g, ycd.T @ ycd, "G")
    if out_dtype == "bfloat16":
        if bool(ref[0].any()):  # (a Yc that is exactly 0 has no rounding to flip)
            flips = float((yc != ref[0]).double().mean())
            assert flips <= 4e-3, ("yc entries differing", flips)
        ycf = yc.float()
        plain_g = (ycf.T @ ycf).double()
        assert float((g.double() - plain_g).norm() / plain_g.norm().clamp_min(1e-30)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("t,n", [(168, 384), (705, 256)])
def test_sketch_center_gram_is_not_one_tf32_pass_on_card(cuda, t, n):
    """K2's sketch and G stages on f32 operands whose entries span six
    decades (the week's T at the d = 3 width, and a T past W's resident
    depth): Yc within 1e-6 max|Yc| of the f64 product X W (no centring), G
    within 1e-6 of the f64 sums of the stored Yc, limits that one TF32 pass
    of each product misses."""
    gen = torch.Generator(device=cuda).manual_seed(53)
    x, w = _wide((20_000, t), gen, cuda), _wide((t, n), gen, cuda)
    yc, _, _, g = matmul.sketch_center_gram(x, w, center=False)
    y64 = yc.double()
    exact = {"Yc": x.double() @ w.double(), "G": y64.T @ y64}
    for name, got in (("Yc", yc), ("G", g)):
        err = float((got.double() - exact[name]).abs().max()) / float(exact[name].abs().max())
        assert err <= 1e-6, (name, err)
    for name, fn in (("Yc", lambda: x @ w), ("G", lambda: yc.T @ yc)):
        err = _one_tf32_pass_err(fn, exact[name])
        assert err > 1e-6, (name, err)


# The edges of K3's block rule (ops/matmul.py::project_block): C's narrow
# side at n 8, 24 and 40, at the widest n whose f64 sums stay in registers
# (88) and 8 short of and past it, at 168 (two pieces), 256 and 257 (three),
# each in both orientations (N < T puts X on the MMA's m side); 97- and
# 133-wide rows on an aligned base (f32: one bulk copy a slab of rows that
# are not 16-byte aligned); a ragged last tile and slab, M < 128 and M = 1
PROJECT_BLOCK_EDGES = [
    (1000, 300, 8), (1000, 8, 300), (1000, 24, 100), (1000, 100, 24), (1000, 97, 40),
    (1000, 40, 97), (1000, 200, 80), (1000, 80, 200), (1000, 200, 88), (1000, 88, 200),
    (1000, 200, 96), (1000, 96, 200), (1000, 384, 168), (1000, 220, 168), (1037, 1000, 256),
    (1037, 256, 1000), (300, 600, 257), (300, 257, 600), (1000, 133, 97), (1000, 97, 133),
    (130, 97, 40), (100, 168, 100), (1, 97, 40), (17, 24, 100),
]

PROJECT_CASES = [
    pytest.param(y_dtype, x_dtype, m, t, n, id=f"y{y_dtype}-x{x_dtype}-m{m}-t{t}-n{n}")
    for y_dtype, x_dtype in [("float32", "float32"), ("bfloat16", "bfloat16"),
                             ("bfloat16", "float32"), ("float32", "bfloat16")]
    # K3's 128 x 128 blocks of C and 16- or 32-row slabs: N and T on no
    # multiple of 8, 16 or 128, N = 1, T = 1, both past 256 at once, and
    # the d = 3 pass's aligned widths (16-byte copies)
    for m, t, n in [(1000, 168, 100), (1031, 8760, 256), (300, 50, 384), (129, 65, 512),
                    (1, 1, 1), (1037, 133, 77), (257, 130, 1), (300, 1, 129), (515, 300, 260),
                    (1000, 168, 384)] + PROJECT_BLOCK_EDGES
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
@pytest.mark.parametrize("y_dtype,x_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                             ("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("m,t,n", [(1000, 97, 40), (1000, 133, 97), (1000, 168, 384),
                                   (300, 600, 257), (1037, 24, 100)])
def test_project_on_unaligned_views_on_card(cuda, y_dtype, x_dtype, m, t, n):
    """K3 on X and Y that are views one element into their buffers, so
    that neither base is 16-byte aligned: the element-wise loads, for an
    operand that one block spans and for one that it cuts.  C within 1e-5
    max|C| of the f64 sums and of the plain version, as the aligned cases."""
    gen = torch.Generator(device=cuda).manual_seed(31)

    def view(rows, cols, dtype):
        buf = torch.randn(rows * cols + 1, generator=gen, device=cuda).to(getattr(torch, dtype))
        return buf[1:].view(rows, cols)

    x, y = view(m, t, x_dtype), view(m, n, y_dtype)
    assert x.data_ptr() % 16 and y.data_ptr() % 16
    c = matmul.project(x, y)
    ref = matmul._project_plain(x, y)
    torch.cuda.synchronize()
    assert c.shape == (n, t)
    _f64_close(c, y.double().T @ x.double(), "C")
    _f64_close(c, ref.double(), "C vs plain", rel=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("y_dtype,x_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                             ("float32", "bfloat16")])
@pytest.mark.parametrize("m,t,n", [(20_000, 168, 384), (20_000, 24, 100), (5_000, 8760, 256)])
def test_project_is_identical_run_to_run_on_card(cuda, y_dtype, x_dtype, m, t, n):
    """K3 reduces its row shares in a fixed order, with no atomics: two
    calls on the same operands give C bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(43)
    x = torch.randn((m, t), generator=gen, device=cuda).to(getattr(torch, x_dtype))
    y = torch.randn((m, n), generator=gen, device=cuda).to(getattr(torch, y_dtype))
    assert torch.equal(matmul.project(x, y), matmul.project(x, y))


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
    _matmul_against_one_tf32_pass(cuda, 168, 110)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(97, 40), (100, 24)])
def test_matmul_is_not_one_tf32_pass_at_a_narrow_width_on_card(cuda, k, n):
    """The same at 16e's and 15c's narrow widths: K 97 by bulk copies at 40
    columns a CTA, K 100 by TMA at 24."""
    _matmul_against_one_tf32_pass(cuda, k, n)


def _matmul_against_one_tf32_pass(cuda, k, n):
    gen = torch.Generator(device=cuda).manual_seed(41)

    def wide(shape):
        mag = 10.0 ** (6 * torch.rand(shape, generator=gen, device=cuda) - 3)
        return torch.randn(shape, generator=gen, device=cuda) * mag

    x, w = wide((20_000, k)), wide((k, n))
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


# K4 where the DMD models take it: the streamed mrDMD refit's block
# (65,536 x 168) and mrDMD windows, column blocks of a row-major residual
# copied dense (level 1 and 2 of T_used 164)
MRDMD_GRAM_CASES = [
    pytest.param(m, t, c0, c1, id=f"m{m}-t{t}-cols{c0}-{c1}")
    for m, t, c0, c1 in [(65_536, 168, 0, 168), (65_536, 164, 82, 164), (65_536, 164, 41, 82)]
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,t,c0,c1", MRDMD_GRAM_CASES)
def test_gram_at_mrdmd_shapes_on_card(cuda, m, t, c0, c1):
    """K4 on the block (or window copy) with entries over six decades:
    within 1e-6 max|G| of the f64 sums, exactly symmetric, a limit that
    one TF32 pass misses."""
    gen = torch.Generator(device=cuda).manual_seed(53)
    a = _wide((m, t), gen, cuda)[:, c0:c1].contiguous()
    exact = a.double().T @ a.double()
    before = qr_panel.gram.launches["highest"]
    g = qr_panel.gram(a)
    torch.cuda.synchronize()
    assert qr_panel.gram.launches["highest"] == before + 1
    assert torch.equal(g, g.T)
    err = float((g.double() - exact).abs().max()) / float(exact.abs().max())
    assert err <= 1e-6, err
    assert _one_tf32_pass_err(lambda: a.T @ a, exact) > 1e-6


def _two_scale(s_rows, t_cols, seed):
    """test_26's slow and fast oscillation pairs and 1e-4 noise, (S, T)."""
    rng = np.random.default_rng(seed)
    t = np.arange(t_cols) * 0.1
    x = sum(amp * (np.outer(rng.standard_normal(s_rows), np.cos(w * t))
                   + np.outer(rng.standard_normal(s_rows), np.sin(w * t)))
            for w, amp in ((0.2, 2.0), (6.0, 0.5)))
    return (x + 1e-4 * rng.standard_normal((s_rows, t_cols))).astype(np.float32)


def _launches():
    return (qr_panel.gram.launches["highest"], matmul.sketch_center_gram_project.launches)


@pytest.mark.cuda
def test_mrdmd_routes_on_card(cuda, tmp_path):
    """fit_mrdmd on a card tensor takes K4 once a window (7 at 3 levels)
    and agrees with its CPU run (eigenvalues matched within 5e-3, test_26's
    tolerance, the slow parts within 1e-4 of max|x|); fit_mrdmd_streamed
    takes it once a block into f64 sums on the card and agrees with it."""
    from dmd_era5_tpu_torch.models import fit_mrdmd, fit_mrdmd_streamed, mrdmd_reconstruct

    x = _two_scale(5000, 256, 0)
    kw = dict(dt=0.1, rank=6, max_levels=3, max_cycles=2.0)
    before = _launches()
    got = fit_mrdmd(torch.from_numpy(x).to(cuda), **kw)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 7, before[1])
    ref = fit_mrdmd(x, device="cpu", **kw)
    for lv, lv_ref in zip(got.levels, ref.levels):
        for w in range(lv.omega.shape[0]):
            om, om_ref = lv.omega[w], lv_ref.omega[w]
            left = list(range(len(om)))
            for o in om_ref:
                i = min(left, key=lambda j: abs(om[j] - o))
                assert abs(om[i] - o) <= 5e-3, (lv.level, w, om, om_ref)
                left.remove(i)
        assert lv.kept_mask.sum() == lv_ref.kept_mask.sum()
    rec = mrdmd_reconstruct(got).cpu().numpy()
    assert np.abs(rec - mrdmd_reconstruct(ref).numpy()).max() <= 1e-4 * np.abs(x).max()

    path = tmp_path / "x.npy"
    np.save(path, x)
    before = _launches()
    streamed = fit_mrdmd_streamed(path, block_rows=1024, return_modes=True, **kw)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 5, before[1])  # 5,000 rows in 1,024-row blocks
    rec_s = mrdmd_reconstruct(streamed).cpu().numpy()
    assert np.linalg.norm(rec_s - rec) / np.linalg.norm(x) < 2e-2


@pytest.mark.cuda
def test_dmdc_and_ensemble_on_card(cuda):
    """DMDc on a card tensor: K4 twice and K1 twice (the two Gram-route
    SVDs), eigenvalues as on the CPU within 2e-3 (test_27); the ensemble:
    K1 once a member, s as on the CPU within 1e-4 relative."""
    from dmd_era5_tpu_torch.models import fit_dmdc
    from dmd_era5_tpu_torch.pipeline import fit_per_variable_level
    from dmd_era5_tpu_torch.snapmat import create_mock_era5

    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((3000, 4)))
    a0 = np.zeros((4, 4))
    for i, (th, g) in enumerate(((0.3, 0.98), (1.1, 0.9))):
        a0[2 * i:2 * i + 2, 2 * i:2 * i + 2] = g * np.array([[np.cos(th), -np.sin(th)],
                                                             [np.sin(th), np.cos(th)]])
    b0 = rng.standard_normal((4, 2))
    u_seq = rng.standard_normal((2, 119)).astype(np.float32)
    z = rng.standard_normal(4)
    cols = [q @ z]
    for k in range(119):
        z = a0 @ z + b0 @ u_seq[:, k]
        cols.append(q @ z)
    x = np.stack(cols, axis=1).astype(np.float32)
    before = _launches()
    res = fit_dmdc(torch.from_numpy(x).to(cuda), u_seq, rank=4)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 2, before[1] + 2)
    ref = fit_dmdc(x, u_seq, rank=4, device="cpu")
    got, want = res.eigenvalues.cpu().numpy(), ref.eigenvalues.numpy()
    assert max(min(abs(got - w)) for w in want) <= 2e-3

    fs = create_mock_era5("2020-01-01", "2020-01-01T23", ["temperature"], [1000, 500], seed=6)
    omega = torch.randn((24, 13), generator=torch.Generator().manual_seed(9))
    before = _launches()
    fit = fit_per_variable_level(fs, 3, omega=omega.to(cuda))
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 2)
    fit_cpu = fit_per_variable_level(fs, 3, omega=omega, device="cpu")
    np.testing.assert_allclose(fit.state.s.cpu().numpy(), fit_cpu.state.s.numpy(), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,t", [(65_536, 168), (5_000, 96)])
def test_project_with_rademacher_panel_on_card(cuda, m, t):
    """K3 as the one-pass sketch calls it, W = Psi^T X with the (m, 256)
    +-1 panel generated on the card: the panel equal to the CPU one bit
    for bit, W within 1e-6 max|W| of the f64 sums (3xTF32) and of the
    plain version, a limit one TF32 pass misses."""
    from dmd_era5_tpu_torch.ops.onepass import psi_panel

    psi = psi_panel(11, 2**31 - 77, m, 256, cuda)
    assert torch.equal(psi.cpu(), psi_panel(11, 2**31 - 77, m, 256))
    x = torch.randn((m, t), generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    before = matmul.project.launches
    w = matmul.project(x, psi)
    torch.cuda.synchronize()
    assert matmul.project.launches == before + 1
    exact = psi.double().T @ x.double()
    scale = float(exact.abs().max())
    assert float((w.double() - exact).abs().max()) <= 1e-6 * scale
    assert float((w - matmul._project_plain(x, psi)).abs().max()) <= 2e-6 * scale
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = psi.T @ x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert float((one_pass.double() - exact).abs().max()) > 1e-6 * scale


@pytest.mark.cuda
def test_pinned_ring_keeps_order_under_a_slow_reader(cuda, tmp_path, monkeypatch):
    """The streamed passes' pinned ring: with a reader slower than the
    card and more blocks than buffers, every block (read into the ring's
    pinned buffers) reaches the card in order and equal to the file's
    rows, trailing columns sliced off on the card; a bf16 artifact's
    blocks too.  The streaming sketch, whose host blocks reach the card
    through pinned memory, equals its CPU run."""
    import time

    from dmd_era5_tpu_torch.pipeline import streamed_fit
    from dmd_era5_tpu_torch.snapmat.loader import save_packed_matrix

    x = torch.randn((10_000, 40), generator=torch.Generator().manual_seed(5))
    real = streamed_fit.read_packed_rows

    def slow(p, r0, r1, **kw):
        time.sleep(0.01)
        return real(p, r0, r1, **kw)

    monkeypatch.setattr(streamed_fit, "read_packed_rows", slow)
    for bf16 in (False, True):
        path = tmp_path / f"x{int(bf16)}.npy"
        save_packed_matrix(path, x, bf16=bf16)
        want = x.to(torch.bfloat16) if bf16 else x
        for t_cols in (40, 33):
            starts, blocks = [], []
            for r0, blk in streamed_fit._device_blocks(path, 10_000, t_cols, 700, cuda):
                torch.cuda._sleep(1 << 20)  # the card busy past the next copy's start
                starts.append(r0)
                blocks.append(blk * 1)  # consumed on the compute stream
            torch.cuda.synchronize()
            assert starts == list(range(0, 10_000, 700))
            assert torch.equal(torch.cat(blocks).cpu(), want[:, :t_cols])

    from dmd_era5_tpu_torch.ops.streaming import StreamingSketch

    omega = torch.randn((40, 8), generator=torch.Generator().manual_seed(6))
    on_card = StreamingSketch(10_000, omega.to(cuda))
    on_host = StreamingSketch(10_000, omega)
    for c0 in range(0, 40, 7):
        on_card.update(x[:, c0:c0 + 7].numpy())
        on_host.update(x[:, c0:c0 + 7].numpy())
    y = on_host.result()
    assert float((on_card.result().cpu() - y).abs().max()) <= 1e-5 * float(y.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 5])
def test_pinned_ring_holds_blocks_under_a_slow_consumer(cuda, tmp_path, monkeypatch, depth):
    """The pinned ring with the reader ahead of the card: each block's
    copy held back on the ring's copy stream and the consumer's work
    slowed on the compute stream, so the reader laps the ring and must
    wait for a slot's last copy before it refills it.  Every block
    reaches the card equal to the file's rows at each reader depth (the
    pass's ring takes depth + 2 slots).  A ring of depth + 1 slots, which
    a reader that far ahead laps, raises in the consumer rather than
    overwrite a block not yet sent."""
    import time

    from dmd_era5_tpu_torch.pipeline import streamed_fit
    from dmd_era5_tpu_torch.snapmat.loader import save_packed_matrix
    from dmd_era5_tpu_torch.utils.tensors import CopyRing

    class SlowCopies(CopyRing):
        def to_device(self, host):
            with torch.cuda.stream(self.stream):
                torch.cuda._sleep(1 << 22)  # the copy stream busy: this copy lags the reader
            return super().to_device(host)

    x = torch.randn((20_000, 40), generator=torch.Generator().manual_seed(7))
    path = tmp_path / "x.npy"
    save_packed_matrix(path, x)
    with monkeypatch.context() as patch:
        patch.setattr(streamed_fit, "CopyRing", SlowCopies)
        blocks = []
        for _, blk in streamed_fit._device_blocks(path, 20_000, 40, 500, cuda, depth=depth):
            torch.cuda._sleep(1 << 22)  # the consumer's work slow on the card
            blocks.append(blk * 1)
        torch.cuda.synchronize()
    assert torch.equal(torch.cat(blocks).cpu(), x)

    ring = CopyRing(cuda, slots=depth + 1)
    with pytest.raises(RuntimeError, match="lapped"):
        for _, blk in streamed_fit.prefetched_row_blocks(path, 20_000, 500, depth,
                                                         _into=ring.host_buffer):
            time.sleep(0.05)  # the reader fills the ring meanwhile
            streamed_fit._to_device(blk, 40, cuda, ring=ring)


@pytest.mark.cuda
def test_onepass_rank_deficient_on_card_against_numpy(cuda):
    """The one-pass sketch of a rank-12 X (5000 x 64) at k = 8 under
    r = 18 in 5 blocks, the same Omega on the card and the host, each
    held to numpy's f64 SVD of X.  Six of G's eigenvalues are the block
    Grams' rounding, so either side's G may not factor under the core's
    tight ridge, and the core then falls back to 1e-3 of its mean
    diagonal (``utils.linalg.safe_cholesky``, as the JAX package's),
    which moves s by up to percent.  Held: each side's W and G within
    1e-6 of max of the f64 sums of the stored X; the core on the f64
    sums within 1e-4 of numpy's s; each side's s equal (1e-6) to the
    host's f64 core on that side's sums; each side's s within test_17's
    tolerances of numpy's (leading 6 within 2e-2, all 8 within 1e-1).
    Printed: each side's readings and whether its G took the tight
    ridge."""
    import json

    from dmd_era5_tpu_torch.ops.onepass import OnePassSketch, onepass_core, psi_panel

    rng = np.random.default_rng(2)
    x = ((rng.standard_normal((5000, 12)) * np.geomspace(10, 1, 12))
         @ rng.standard_normal((12, 64))).astype(np.float32)
    omega = torch.from_numpy(rng.standard_normal((64, 18)).astype(np.float32))
    s_np = np.linalg.svd(x.astype(np.float64), compute_uv=False)[:8]
    x64 = torch.from_numpy(x).double()
    y64 = x64 @ omega.double()
    w64, g64 = psi_panel(0, 0, 5000, 36).double().T @ x64, y64.T @ y64
    eye = torch.eye(18, dtype=torch.float64)

    def tight(g):
        return int(torch.linalg.cholesky_ex(g + 1e-7 * g.diagonal().mean() * eye).info) == 0

    _, s_exact, _, _ = onepass_core(w64, g64, omega, 8)
    readings = {"f64_sums": {"tight_ridge": tight(g64),
                             "rel": float(np.abs(s_exact.numpy() / s_np - 1).max())}}
    sides = {}
    for name, dev in (("card", cuda), ("host", "cpu")):
        sk = OnePassSketch(64, 8, device=dev, omega=omega)
        for r0 in range(0, 5000, 1000):
            sk.update(r0, torch.from_numpy(x[r0:r0 + 1000]))
        w, g = sk.w.cpu(), sk.g.cpu()
        s = sk.finalize().s.cpu().numpy()
        _, s_core, _, _ = onepass_core(w, g, omega, 8)
        rel = np.abs(s / s_np - 1)
        sides[name] = (w, g, s, s_core.numpy())
        readings[name] = {"tight_ridge": tight(g), "lead6": float(rel[:6].max()),
                          "all8": float(rel.max()),
                          "w_vs_f64": float((w - w64).abs().max() / w64.abs().max()),
                          "g_vs_f64": float((g - g64).abs().max() / g64.abs().max())}
    print(json.dumps(readings))
    np.testing.assert_allclose(s_exact.numpy(), s_np, rtol=1e-4)
    for name, (w, g, s, s_core) in sides.items():
        assert readings[name]["w_vs_f64"] <= 1e-6 and readings[name]["g_vs_f64"] <= 1e-6, name
        np.testing.assert_allclose(s, s_core, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(s[:6], s_np[:6], rtol=2e-2, err_msg=name)
        np.testing.assert_allclose(s, s_np, rtol=1e-1, err_msg=name)


@pytest.mark.cuda
def test_onepass_and_rank_update_on_card(cuda, tmp_path):
    """The one-pass route and the rank update on the card against their
    CPU runs with the same sketch: streamed_onepass_svd over an .npy in
    5 blocks (K6 10, K3 5, K4 5), s within 1e-5 relative and U within
    1e-4 of max, on a full-rank X whose sketch Gram sits well above f32
    resolution (where it does not, as past a rank-12 X's twelve
    directions, its noise directions are rounding in both sums, and the
    two runs' s part by percent); svd_rank_update (K3 1, K6 1 + lift
    chunks), s within 1e-5."""
    from dmd_era5_tpu_torch.ops.onepass import default_sketch_width
    from dmd_era5_tpu_torch.ops.streaming import svd_rank_update
    from dmd_era5_tpu_torch.ops.svd import exact_truncated_svd
    from dmd_era5_tpu_torch.pipeline import streamed_onepass_svd_core

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((5000, 64)) * np.geomspace(10, 1, 64)).astype(np.float32)
    path = tmp_path / "x.npy"
    np.save(path, x)
    omega = torch.from_numpy(rng.standard_normal((64, default_sketch_width(8, None))).astype(np.float32))
    launches = lambda: (matmul.matmul.launches, matmul.project.launches,  # noqa: E731
                        qr_panel.gram.launches["highest"])
    before = launches()
    got = streamed_onepass_svd_core(path, omega, 8, block_rows=1000, device=cuda)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(launches(), before)) == (10, 5, 5)
    ref = streamed_onepass_svd_core(path, omega, 8, block_rows=1000, device="cpu")
    np.testing.assert_allclose(got.s.cpu().numpy(), ref.s.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got.U, ref.U, atol=1e-4 * np.abs(ref.U).max())

    base = exact_truncated_svd(torch.from_numpy(x[:, :48]), 8)
    new = torch.from_numpy(x[:, 48:])
    before = launches()
    upd = svd_rank_update(type(base)(*(a.to(cuda) for a in base)), new.to(cuda))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(launches(), before)) == (2, 1, 0)
    upd_cpu = svd_rank_update(base, new)
    np.testing.assert_allclose(upd.s.cpu().numpy(), upd_cpu.s.numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 110])
def test_cholqr_solve_in_row_blocks_equals_one_solve_on_card(cuda, n):
    """cholqr whitens A in ``SOLVE_ROWS``-row blocks (one library solve on
    a narrow R over 2^20 and more rows takes seconds), over several blocks
    and a ragged last one: at n 20 Q equals the one solve's bit for bit;
    at n 110 the library sums the blocks in another order than the whole,
    and Q is within 1e-6 of it (relative Frobenius, a few ulps)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    m = 3 * qr_panel.SOLVE_ROWS + 123
    a = torch.randn((m, n), generator=gen, device=cuda)
    q, r = qr_panel.cholqr(a)
    one = torch.linalg.solve_triangular(r.T, a.T, upper=False).T
    if n == 20:
        assert torch.equal(q, one)
    assert float((q.double() - one.double()).norm() / one.double().norm()) <= 1e-6
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    assert float((q.double().T @ q.double() - eye).abs().max()) < 1e-4


@pytest.mark.cuda
def test_unfused_hankel_operators_and_svd_on_card(cuda):
    """hankel_sketch (K6) and hankel_project (K3) against their CPU runs
    (plain versions) on the same operands, and hankel_randomized_svd with
    the card's default leaf (the split CholQR2, K5 twice a leaf) against
    the CPU run (the library QR leaf) with the same sketch: launches
    exact, s within 1e-5 relative, U and V within 1e-4 of max, on a
    decaying spectrum whose embedded sketch spans several solve blocks."""
    from dmd_era5_tpu_torch.ops import hankel_project, hankel_randomized_svd, hankel_sketch

    rng = np.random.default_rng(8)
    s_rows, t_cols, d, k, n_over = 70_000, 40, 2, 6, 10
    x = ((rng.standard_normal((s_rows, 12)) * np.geomspace(30, 1, 12)) @ rng.standard_normal(
        (12, t_cols)) + 0.01 * rng.standard_normal((s_rows, t_cols))).astype(np.float32)
    omega = rng.standard_normal((t_cols - d + 1, k + n_over)).astype(np.float32)
    xt, ot = torch.from_numpy(x), torch.from_numpy(omega)
    xc, oc = xt.to(cuda), ot.to(cuda)
    y, y_cpu = hankel_sketch(xc, oc, d), hankel_sketch(xt, ot, d)
    assert float((y.cpu() - y_cpu).abs().max()) <= 1e-5 * float(y_cpu.abs().max())
    b, b_cpu = hankel_project(y, xc, d), hankel_project(y_cpu, xt, d)
    assert float((b.cpu() - b_cpu).abs().max()) <= 1e-5 * float(b_cpu.abs().max())

    n_iter = 4  # sklearn's auto rule: k >= 0.1 min(S d, T - d + 1)
    before = (matmul.matmul.launches, matmul.project.launches, qr_panel.gram.launches["bf16_split"])
    got = hankel_randomized_svd(xc, d, k, omega=oc)
    torch.cuda.synchronize()
    after = (matmul.matmul.launches, matmul.project.launches, qr_panel.gram.launches["bf16_split"])
    assert tuple(a - b for a, b in zip(after, before)) == (n_iter + 1, n_iter + 1, 2 * (n_iter + 1))
    ref = hankel_randomized_svd(xt, d, k, omega=ot)
    np.testing.assert_allclose(got.s.cpu().numpy(), ref.s.numpy(), rtol=1e-5)
    for a, b in ((got.U, ref.U), (got.V, ref.V)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_lstsq_implicit_jvp_and_vjp_on_card(cuda):
    """``lstsq_implicit`` on CUDA tensors: ``torch.func.jacfwd`` through its
    rule and ``torch.func.vjp`` through its backward against the same
    transforms straight through ``complex_lstsq``, on
    tests/test_13_checkpoint.py:78-115's case (rtol 1e-3, atol 1e-4)."""
    from dmd_era5_tpu_torch.models.optdmd import _func
    from dmd_era5_tpu_torch.utils.linalg import complex_lstsq, lstsq_implicit

    func = _func()
    rng = np.random.default_rng(0)
    tt = torch.arange(20, dtype=torch.float32, device=cuda) * 0.1
    h = torch.from_numpy((rng.standard_normal((20, 4)) + 1j * rng.standard_normal((20, 4)))
                         .astype(np.complex64)).to(cuda)
    theta = torch.tensor([-0.1, -0.2, -0.05, 1.0, -0.5, 2.0], device=cuda)

    def b_of(solve):
        def f(th):
            a = torch.complex(th[:3], th[3:])
            b = solve(torch.exp(torch.outer(tt.to(a.dtype), a)), h)
            return torch.cat([b.real.reshape(-1), b.imag.reshape(-1)])
        return f

    implicit, direct = b_of(lstsq_implicit), b_of(complex_lstsq)
    j_i, j_d = func.jacfwd(implicit)(theta), func.jacfwd(direct)(theta)
    assert j_i.is_cuda and j_i.shape == (24, 6)
    torch.testing.assert_close(j_i, j_d, rtol=1e-3, atol=1e-4)
    c = torch.from_numpy(rng.standard_normal(24).astype(np.float32)).to(cuda)
    g_i = func.vjp(implicit, theta)[1](c)[0]
    g_d = func.vjp(direct, theta)[1](c)[0]
    torch.testing.assert_close(g_i, g_d, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(g_i, c @ j_d, rtol=1e-3, atol=1e-4)
