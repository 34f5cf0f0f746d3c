"""The Hopper kernels against their plain PyTorch versions, on the card.

Every flag combination of ``sketch_center_gram_project`` in float32 and
bfloat16, at a ragged row count and both kernel width classes; ``gram``
at both precisions, float32 and bfloat16 input, ragged row counts and
panel widths past the JAX kernel's 1024.  Needs a CUDA card and nvcc;
elsewhere each case skips.  JAX is not needed, so on a machine without
it run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import itertools

import pytest
import torch

from dmd_era5_tpu_torch.ops import matmul, qr_panel

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
