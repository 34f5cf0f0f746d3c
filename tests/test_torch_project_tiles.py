"""K3's block rule on the CPU: ``ops/matmul.py::project_block`` and the
grid that ``_project_row_shares`` sizes from it.

The kernel (``csrc/project_wgmma.cuh``) runs only on a card; what it is
handed is plain Python, held here: every K3 shape of the smoke's main
path maps to the block the kernel's design names for it (C's narrow side
on the MMA's n, the wide side in 128-column blocks), n is a wgmma width
of the kernel's table, the f64 sums sit in registers only within their
budget, the blocks cover C, and the block count reaches
``wave_row_shares``.
"""

from __future__ import annotations

import itertools

import pytest
import torch

from dmd_era5_tpu_torch.ops import matmul
from dmd_era5_tpu_torch.ops.matmul import ProjectBlock, project_block

F32, BF16 = torch.float32, torch.bfloat16
WEEK = 721 * 1440 * 15  # the ERA5 week's rows
YEAR = 181 * 360 * 15  # the hourly 1-degree year's

# (label, M, N = Y's columns, T = X's columns, Y's dtype, X's dtype, block)
MAIN_PATH = [
    ("d3_pass", WEEK, 384, 168, BF16, BF16, ProjectBlock(False, 128, 88, 3, 2, "shared")),
    ("15c_UtC", 2 * WEEK, 100, 24, F32, F32, ProjectBlock(False, 128, 24, 1, 1, "registers")),
    ("16e_hankel_project", 721 * 1440, 40, 97, F32, F32,
     ProjectBlock(True, 128, 40, 1, 1, "registers")),
    ("year_n256", YEAR, 256, 8760, F32, F32,
     ProjectBlock(False, 128, 128, 2, 69, "shared", "row_share")),
    ("year_n128", YEAR, 128, 8760, F32, F32,
     ProjectBlock(False, 128, 128, 1, 69, "shared", "row_share")),
    ("15a_block", 65_536, 256, 168, F32, F32, ProjectBlock(False, 128, 88, 2, 2, "shared")),
    ("18b_P2", WEEK // 2, 220, 168, F32, F32, ProjectBlock(False, 128, 88, 2, 2, "shared")),
    ("18b_P3", WEEK // 3, 220, 168, F32, F32, ProjectBlock(False, 128, 88, 2, 2, "shared")),
    ("18c_rank0", 1 << 19, 220, 84, F32, F32, ProjectBlock(False, 128, 88, 2, 1, "shared")),
]


@pytest.mark.parametrize("label,m,n,t,y_dtype,x_dtype,block", MAIN_PATH,
                         ids=[case[0] for case in MAIN_PATH])
def test_main_path_shapes_take_their_blocks(label, m, n, t, y_dtype, x_dtype, block):
    assert project_block(m, n, t, y_dtype, x_dtype) == block


WIDTHS = [1, 7, 8, 9, 24, 40, 80, 87, 88, 89, 96, 100, 128, 168, 176, 220, 256, 257, 384, 1000,
          8760]
PAIRS = [(F32, F32), (BF16, BF16), (BF16, F32), (F32, BF16)]


def _blocks():
    for (n, t), (y_dtype, x_dtype) in itertools.product(itertools.product(WIDTHS, WIDTHS), PAIRS):
        yield n, t, y_dtype, x_dtype, project_block(1000, n, t, y_dtype, x_dtype)


def _new_blocks():
    """The blocks of project_wgmma (the f32 x f32 ones with a side past
    _PROJECT_ROW_SHARE_WIDE stay on the row-share mainloop)."""
    for n, t, y_dtype, x_dtype, block in _blocks():
        row_share = y_dtype == x_dtype == F32 and max(n, t) > matmul._PROJECT_ROW_SHARE_WIDE
        assert block.mainloop == ("row_share" if row_share else "project_wgmma"), block
        if row_share:
            assert block == ProjectBlock(False, 128, 128, -(-n // 128), -(-t // 128), "shared",
                                         "row_share")
        else:
            yield n, t, y_dtype, x_dtype, block


def test_n_is_a_wgmma_width_of_the_table():
    for n, t, y_dtype, x_dtype, block in _new_blocks():
        assert block.n % 8 == 0 and 8 <= block.n <= 256, (n, t, block)
        assert block.m == 128


def test_sums_in_registers_only_within_their_budget():
    for n, t, y_dtype, x_dtype, block in _new_blocks():
        assert block.n <= matmul._PROJECT_N_MAX, (n, t, block)
        if block.sums == "registers":
            assert block.n <= matmul._PROJECT_REG_N, block
        else:
            assert block.sums == "shared" and block.n in matmul._PROJECT_SMEM_WIDTHS, block


def test_blocks_cover_c_on_the_narrow_side():
    """The narrow side on n unless the other orientation has fewer MMA
    entries (the f32 operand on the m side for a mixed pair), cut into the
    fewest pieces of a width no more than needed."""
    for n, t, y_dtype, x_dtype, block in _new_blocks():
        if y_dtype != x_dtype:
            assert block.transposed == (y_dtype == BF16)
        elif block.transposed != (n < t):
            other = block._replace(transposed=not block.transposed)
            wide, narrow = (n, t) if block.transposed else (t, n)
            pieces = -(-narrow // matmul._PROJECT_N_MAX)
            o_n = 8 * -(-(-(-narrow // pieces)) // 8)
            other = other._replace(n=o_n, m_blocks=-(-wide // 128), n_blocks=-(-narrow // o_n))
            assert (block.m_blocks * block.n_blocks * block.n
                    < other.m_blocks * other.n_blocks * other.n), (n, t, block)
        wide, narrow = (t, n) if block.transposed else (n, t)
        assert block.m_blocks == -(-wide // 128)
        assert block.n_blocks * block.n >= narrow > (block.n_blocks - 1) * block.n
        assert block.n - 8 < -(-narrow // block.n_blocks) <= block.n
        if narrow <= matmul._PROJECT_N_MAX:
            assert block.n_blocks == 1 and block.n == 8 * -(-narrow // 8)


@pytest.mark.parametrize("label,m,n,t,y_dtype,x_dtype,block", MAIN_PATH,
                         ids=[case[0] for case in MAIN_PATH])
def test_row_shares_get_the_block_count(monkeypatch, label, m, n, t, y_dtype, x_dtype, block):
    """_project_row_shares hands wave_row_shares the CTAs of a wave, the
    rule's blocks (m_blocks x n_blocks), the rows and an N x T f64 share,
    and the launch flags name the rule's block."""
    seen = {}

    def wave(dev, flags):
        seen["flags"] = flags
        return 132

    def shares(wave_ctas, n_blocks, rows, share_bytes):
        seen["args"] = (wave_ctas, n_blocks, rows, share_bytes)
        return 7

    monkeypatch.setattr(matmul, "_project_wave", wave)
    monkeypatch.setattr(matmul, "wave_row_shares", shares)
    x = torch.empty((m, t), dtype=x_dtype, device="meta")
    y = torch.empty((m, n), dtype=y_dtype, device="meta")
    assert matmul._project_row_shares(x, y) == 7
    assert seen["args"] == (132, block.m_blocks * block.n_blocks, m, 8 * n * t)
    assert seen["flags"] == (int(y_dtype == BF16), int(x_dtype == BF16), int(block.transposed),
                             block.n if block.mainloop == "project_wgmma" else 0,
                             int(block.sums == "shared"))


def test_d3_pass_fills_whole_waves():
    """At the d = 3 pass the six blocks of a share fill 132 SMs in 22
    shares (one wave), as wave_row_shares computes."""
    from dmd_era5_tpu_torch.ops._occupancy import wave_row_shares

    block = project_block(WEEK, 384, 168, BF16, BF16)
    assert wave_row_shares(132, block.m_blocks * block.n_blocks, WEEK, 8 * 384 * 168) == 22
