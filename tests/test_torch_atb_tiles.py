"""The block tables of K4's, K1's and K2's G and K1's C stages on the CPU:
``ops/atb.py::gram_block`` (the row-share Gram kernel) and, for K1's C
stage, K3's ``ops/matmul.py::project_block``, and the grid the Gram
kernel builds from its block.

The kernels (``csrc/atb_wgmma.cuh``, ``csrc/project_wgmma.cuh``) run only
on a card; what they are handed is plain Python, held here: every
main-path shape of K4, K1's and K2's G stage and K1's C stage takes its
block, the width is a wgmma width of the kernel's table, the f64 sums sit
in registers only within their budget, the blocks cover G's upper
triangle and all of C, and a call whose rows fit one share takes the
one-launch route.
"""

from __future__ import annotations

import itertools

import pytest
import torch

from dmd_era5_tpu_torch.ops import _occupancy, atb, matmul
from dmd_era5_tpu_torch.ops.atb import AtbBlock, gram_block, upper_blocks
from dmd_era5_tpu_torch.ops.matmul import ProjectBlock, project_block

F32, BF16 = torch.float32, torch.bfloat16
WEEK = 721 * 1440 * 15  # the ERA5 week's rows
YEAR = 181 * 360 * 15  # the hourly 1-degree year's

# K4 and the G stages (label, M, K, dtype, block): one block to K 88, 128 x N
# upper blocks past it, the row-share mainloop for the f32 Grams where it
# reads faster (ops/atb.py's table)
RS = "row_share"
GRAM_MAIN_PATH = [
    ("15a_Y_block", 65_536, 128, F32, AtbBlock(128, 1, 1, 1, "shared", RS)),
    ("week_sketch_Y", WEEK, 110, F32, AtbBlock(128, 1, 1, 1, "shared", RS)),
    ("week_X", WEEK, 168, F32, AtbBlock(56, 2, 3, 4, "shared2")),
    ("14c_window", 2 * WEEK, 82, F32, AtbBlock(88, 1, 1, 1, "shared", early=True)),
    ("19c_dmdc_stack", 34, 166, F32, AtbBlock(56, 2, 3, 4, "registers")),
    ("19d_dmdc_block", 6, 95, F32, AtbBlock(48, 1, 2, 2, "registers", early=True)),
    ("config2_G_N76", 1_038_240, 76, F32, AtbBlock(80, 1, 1, 1, "shared", early=True)),
    ("fit_step_G_N128_f32", WEEK, 128, F32, AtbBlock(128, 1, 1, 1, "shared", RS)),
    ("fit_step_G_N128_bf16", WEEK, 128, BF16,
     AtbBlock(64, 1, 2, 2, "registers", early=True)),
    ("hankel_pass_G_N256", WEEK, 256, F32, AtbBlock(128, 2, 2, 3, "shared", RS)),
    ("d3_K2_G_N384", WEEK, 384, BF16, AtbBlock(64, 3, 6, 12, "registers")),
    ("cholqr_leaf_22", 4096, 22, F32, AtbBlock(24, 1, 1, 1, "registers", early=True)),
]


@pytest.mark.parametrize("label,m,k,dtype,block", GRAM_MAIN_PATH, ids=[c[0] for c in GRAM_MAIN_PATH])
def test_gram_main_path_shapes_take_their_blocks(label, m, k, dtype, block):
    assert gram_block(k, dtype, m) == block


# K1's C stage on K3's kernel (label, N = Yc's columns, T = X's, Yc's dtype,
# X's dtype, block): project_block's, C's narrow side on the MMA's n unless
# the other orientation has fewer MMA entries (Y on m at 128 x 168), the
# f32 C with a side past 384 on the row-share mainloop
C_MAIN_PATH = [
    ("hankel_pass_N256", 256, 168, F32, F32, ProjectBlock(False, 128, 88, 2, 2, "shared")),
    ("fit_step_f32", 128, 168, F32, F32, ProjectBlock(False, 128, 88, 1, 2, "shared")),
    ("fit_step_bf16", 128, 168, BF16, BF16, ProjectBlock(False, 128, 88, 1, 2, "shared")),
    ("config2_N76", 76, 97, F32, F32, ProjectBlock(True, 128, 80, 1, 1, "shared")),
    ("bench_f32", 128, 512, F32, F32, ProjectBlock(False, 128, 128, 1, 4, "shared", RS)),
    ("bench_bf16", 128, 512, BF16, BF16, ProjectBlock(True, 128, 64, 4, 2, "registers")),
    ("19c_stack", 128, 166, F32, F32, ProjectBlock(False, 128, 88, 1, 2, "shared")),
    ("19d_block", 95, 95, F32, F32, ProjectBlock(False, 128, 48, 1, 2, "registers")),
    ("bf16_yc_f32_x", 128, 168, BF16, F32, ProjectBlock(True, 128, 64, 2, 2, "registers")),
    ("f32_yc_bf16_x", 128, 168, F32, BF16, ProjectBlock(False, 128, 88, 1, 2, "shared")),
    ("year_N256", 256, 8760, F32, F32, ProjectBlock(False, 128, 128, 2, 69, "shared", RS)),
]


@pytest.mark.parametrize("label,n,t,y_dtype,x_dtype,block", C_MAIN_PATH,
                         ids=[c[0] for c in C_MAIN_PATH])
def test_c_main_path_shapes_take_their_blocks(label, n, t, y_dtype, x_dtype, block):
    assert project_block(WEEK, n, t, y_dtype, x_dtype) == block


# csrc/project.cu's instantiated widths
K3_REG_WIDTHS = set(range(8, matmul._PROJECT_REG_N + 1, 8))
K3_SMEM_WIDTHS = set(matmul._PROJECT_SMEM_WIDTHS)


@pytest.mark.parametrize("label,n,t,y_dtype,x_dtype,block", C_MAIN_PATH,
                         ids=[c[0] for c in C_MAIN_PATH])
def test_c_main_path_blocks_are_k3_instantiations(label, n, t, y_dtype, x_dtype, block):
    """Each C block is one K3 launches: a width of project.cu's table for
    its sums, or the row-share mainloop's 128 x 128 for f32 x f32 only."""
    if block.mainloop == "row_share":
        assert y_dtype == x_dtype == F32 and block.n == block.m == 128
    else:
        assert block.mainloop == "project_wgmma" and block.m == 128
        assert block.n in (K3_REG_WIDTHS if block.sums == "registers" else K3_SMEM_WIDTHS)


def test_k1_c_stage_at_the_year_takes_k3s_row_share_route():
    """The hourly year's f32 X (T 8,760): K1's C stage takes the route K3
    takes there (project_block's row-share mainloop), so K1 and the two
    passes read alike (chip_smoke's K1_VS_TWO_PASS); so does any f32 C
    with a side past 384 (the bench's T 512), and no bf16 one."""
    for n in (128, 256):
        assert project_block(YEAR, n, 8760, F32, F32).mainloop == "row_share"
    assert project_block(WEEK, 128, 512, F32, F32).mainloop == "row_share"
    assert project_block(WEEK, 128, 384, F32, F32).mainloop == "project_wgmma"
    assert project_block(WEEK, 256, 168, F32, F32).mainloop == "project_wgmma"
    assert project_block(WEEK, 128, 512, BF16, BF16).mainloop == "project_wgmma"


WIDTHS = [1, 7, 8, 9, 22, 24, 40, 64, 65, 76, 82, 88, 89, 95, 97, 100, 110, 112, 120, 128, 129,
          166, 168, 176, 192, 200, 256, 257, 300, 384, 385, 512, 1000, 2048]
# the kernel's instantiated widths (csrc/atb.cu): registers to 64, shared
# memory past it, to 88
REG_WIDTHS = set(range(8, atb.REG_N + 1, 8))
SMEM_WIDTHS = set(range(atb.REG_N + 8, atb.N_MAX + 1, 8))
DUAL_WIDTHS = set(range(32, atb.REG_N + 1, 8))  # f32 only


def _in_table(block: AtbBlock) -> bool:
    widths = {"registers": REG_WIDTHS, "shared2": DUAL_WIDTHS, "shared": SMEM_WIDTHS}[block.sums]
    return block.n in widths


def _gram_blocks():
    for k, dtype, m in itertools.product(WIDTHS, (F32, BF16), (None, 34, WEEK)):
        yield k, dtype, m, gram_block(k, dtype, m)


def test_gram_blocks_are_widths_of_the_table():
    for k, dtype, m, block in _gram_blocks():
        if block.mainloop == "row_share":  # an f32 Gram past one tile, 128 x 128 blocks
            assert dtype == F32 and m != 34 and block.n == 128 and block.sums == "shared"
            assert not (k <= atb.GRAM_ONE_BLOCK or atb.BM < k <= 192), (k, block)
            continue
        assert block.mainloop == "atb_wgmma"
        assert block.n % 8 == 0 and 8 <= block.n <= atb.N_MAX, (k, block)
        assert _in_table(block), (k, block)
        # two CTAs an SM only for the f32 Grams of two m blocks past one tile
        assert (block.sums == "shared2") == (dtype == F32 and m != 34 and atb.BM < k <= 192)
        assert block.early == (block.m_blocks == 1)


def _c_blocks():
    """K1's C blocks on project_wgmma (f32 x f32 with a side past
    _PROJECT_ROW_SHARE_WIDE takes the row-share mainloop)."""
    for (n, t), (y_dtype, x_dtype) in itertools.product(
            itertools.product(WIDTHS, WIDTHS), [(F32, F32), (BF16, BF16), (BF16, F32), (F32, BF16)]):
        block = project_block(WEEK, n, t, y_dtype, x_dtype)
        wide_f32 = y_dtype == x_dtype == F32 and max(n, t) > matmul._PROJECT_ROW_SHARE_WIDE
        assert (block.mainloop == "row_share") == wide_f32, (n, t, block)
        if not wide_f32:
            yield n, t, y_dtype, x_dtype, block


def test_c_blocks_are_widths_of_the_table():
    for n, t, y_dtype, x_dtype, block in _c_blocks():
        assert block.n % 8 == 0 and 8 <= block.n <= matmul._PROJECT_N_MAX, (n, t, block)
        assert block.n in (K3_REG_WIDTHS if block.sums == "registers" else K3_SMEM_WIDTHS)
        assert (block.sums == "registers") == (block.n <= matmul._PROJECT_REG_N), (n, t, block)
        if y_dtype != x_dtype:  # the f32 operand on the MMA's m side
            assert block.transposed == (y_dtype == BF16), (n, t, block)


def _launched_gram_blocks(k: int, n: int) -> list[tuple[int, int]]:
    """(mi, ni) of every CTA of a Gram launch, as the kernel's block_of maps
    blockIdx.x: row-major over ni >= mi BM // n."""
    n_blocks = -(-k // n)
    out = []
    for idx in range(upper_blocks(k, n)):
        mi = 0
        while idx >= n_blocks - mi * atb.BM // n:
            idx -= n_blocks - mi * atb.BM // n
            mi += 1
        out.append((mi, mi * atb.BM // n + idx))
    return out


@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("dtype,m", [(F32, WEEK), (BF16, WEEK), (F32, 34)])
def test_gram_blocks_cover_the_upper_triangle_once(k, dtype, m):
    """Every entry r <= c of G lies in exactly one launched block, every
    launched block holds one, and the count is the kernel's grid."""
    block = gram_block(k, dtype, m)
    bm = 128  # the m side of both mainloops' blocks
    launched = _launched_gram_blocks(k, block.n)
    assert len(launched) == len(set(launched)) == block.blocks
    covered = torch.zeros((k, k), dtype=torch.int32)
    for mi, ni in launched:
        r0, c0 = mi * bm, ni * block.n
        assert mi < block.m_blocks and ni < block.n_blocks
        tile = covered[r0:r0 + bm, c0:c0 + block.n]
        assert tile.numel() > 0
        r = torch.arange(r0, r0 + tile.shape[0])[:, None]
        c = torch.arange(c0, c0 + tile.shape[1])[None, :]
        assert bool((r <= c).any()), (k, mi, ni)  # holds an upper entry
        tile += 1
    upper = torch.triu(torch.ones((k, k), dtype=torch.bool))
    assert bool((covered[upper] == 1).all())


def test_gram_block_leaves_fewest_mma_columns():
    """Past one block this mainloop's width leaves the fewest MMA columns
    (blocks x N) of the table's register widths, and one block is never
    wider than K rounded up to 8."""
    for k, dtype, m, block in _gram_blocks():
        if block.mainloop == "row_share":
            continue
        if k <= atb.GRAM_ONE_BLOCK:
            assert block.blocks == 1 and block.n == 8 * -(-k // 8)
            continue
        cost = block.blocks * block.n
        for w in (32, 40, 48, 56, 64):
            assert cost <= upper_blocks(k, w) * w, (k, w, block)


@pytest.mark.parametrize("n,t", [(256, 168), (76, 97), (128, 512), (95, 95), (384, 168), (1, 1),
                                 (2048, 8760), (257, 89)])
def test_c_blocks_cover_c(n, t):
    """K1's C blocks tile C (or C^T where transposed): the m side in 128
    columns, the n side in pieces of block.n, nothing left over and no
    block wholly outside; of the two orientations the fewer MMA entries,
    C's narrow side on n on a tie, unless the pair's types fix it."""
    for pair in [(F32, F32), (BF16, BF16), (BF16, F32), (F32, BF16)]:
        block = project_block(WEEK, n, t, *pair)
        if block.mainloop == "row_share":
            assert block.m_blocks * block.n_blocks == -(-n // 128) * -(-t // 128)
            continue
        wide, narrow = (t, n) if block.transposed else (n, t)
        assert block.m_blocks == -(-wide // block.m) and block.n_blocks == -(-narrow // block.n)
        assert (block.n_blocks - 1) * block.n < narrow <= block.n_blocks * block.n
        if pair[0] == pair[1]:
            area = block.m_blocks * block.m * block.n_blocks * block.n
            o_wide, o_narrow = (narrow, wide)
            pieces = -(-o_narrow // matmul._PROJECT_N_MAX)
            o_n = 8 * -(-(-(-o_narrow // pieces)) // 8)
            o_area = -(-o_wide // block.m) * block.m * -(-o_narrow // o_n) * o_n
            assert area <= o_area
            if area == o_area:
                assert block.transposed == (n < t)


@pytest.mark.parametrize("m,k,one_launch", [(34, 166, True), (6, 95, True), (5, 95, True),
                                            (1, 128, True), (128, 110, True), (129, 110, False),
                                            (65_536, 128, False), (WEEK, 168, False)])
def test_small_m_takes_the_one_launch_route(m, k, one_launch):
    """One row share (no f64 scratch, no reduction launch) where the rows
    fit one 128-row tile, on this mainloop; whole waves of the card's CTAs
    elsewhere (132 SMs, one CTA each)."""
    block = gram_block(k, F32, m)
    shares = _occupancy.wave_row_shares(132, block.blocks, m, 8 * k * k)
    assert (shares == 1) == one_launch, shares
    if one_launch:
        assert block.mainloop == "atb_wgmma"


# csrc/atb_wgmma.cuh's Cfg, mirrored: its chains a slab, ring slots and
# shared memory for every instantiation of csrc/atb.cu
SMEM_CAP, MAX_RING, THREADS = 232_448, 8, 256


def _cfg(size: int, n: int, kind: str) -> dict:
    bf16 = size == 2
    ssums, ctas = kind != "registers", 2 if kind == "shared2" else 1
    nacc, h = n // 2, 32 if bf16 else 16
    sums = nacc * THREADS * 8 if ssums else 0
    cap = SMEM_CAP if ctas == 1 else (233_472 - 2 * 1024) // 2
    plane = 0 if bf16 else h * n * 4
    half = 2 * plane

    def slot_of(ch):
        b = (-(-n // 64) * ch * h * 128 if bf16 else -(-(ch * h * n * size) // 1024) * 1024)
        return ch * h * 128 * size + b

    def ring_of(ch):
        return (cap - 1024 - 2 * ch * half - sums - MAX_RING * 8) // slot_of(ch)

    regs = 2 * nacc + nacc + (0 if ssums else 2 * nacc) + (16 if bf16 else 32)
    ch = 2 if ctas == 1 and regs <= 200 and ring_of(2) >= 3 else 1
    ring = min(ring_of(ch), MAX_RING)
    smem = 1024 + ring * slot_of(ch) + 2 * ch * half + sums + ring * 8
    return dict(ch=ch, ring=ring, smem=smem, cap=cap, ctas=ctas)


INSTANTIATIONS = [
    (size, n, kind)
    for size in (4, 2)
    for kind, widths in [("registers", REG_WIDTHS), ("shared", SMEM_WIDTHS),
                         ("shared2", DUAL_WIDTHS if size == 4 else set())]
    for n in sorted(widths)
]


@pytest.mark.parametrize("size,n,kind", INSTANTIATIONS)
def test_every_instantiation_fits_its_shared_memory(size, n, kind):
    """Each instantiation keeps at least three ring slots (two with two CTAs
    an SM) within its share of the SM's shared memory; two chains a slab
    only with one CTA an SM."""
    cfg = _cfg(size, n, kind)
    assert cfg["ring"] >= (2 if cfg["ctas"] == 2 else 3), cfg
    assert cfg["smem"] <= cfg["cap"], cfg
    assert cfg["ch"] == 1 or cfg["ctas"] == 1


def test_table_blocks_use_two_chains_where_they_fit():
    """The week's f32 X (two CTAs an SM) runs one chain a slab; the bf16
    fit step's G and K2's d = 3 G (f64 sums in registers, n 64) two."""
    assert _cfg(4, 56, "shared2")["ch"] == 1
    assert _cfg(2, 64, "registers")["ch"] == 2
    assert _cfg(4, 88, "shared")["ch"] == 2
