"""The Hopper kernel against its plain PyTorch version, on the card.

Every flag combination of ``sketch_center_gram_project`` in float32 and
bfloat16, at a ragged row count and both kernel width classes.  Needs a
CUDA card and nvcc; elsewhere each case skips.  JAX is not needed, so on
a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import itertools

import pytest
import torch

from dmd_era5_tpu_torch.ops import matmul

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
