"""The block rule of K6 and of K1's sketch stage on the CPU:
``ops/matmul.py::matmul_block``.

The kernel (``csrc/matmul_tc.cuh``) runs only on a card; what it is
handed is plain Python, held here: every K6 and K1-sketch shape of the
smoke's paths maps to the width and copy path the kernel's tile table
names for it, the width is one the kernel instantiates for that operand
type and copy path (read from the source's ``with_kind``), the CTA
columns cover N, the ring has 2 to 4 slots and as many as the shared
memory holds, w's rows are all of K or whole panels, and the CTA's shared
memory fits 227 KB.
"""

from __future__ import annotations

import itertools
import re
from pathlib import Path

import pytest
import torch

from dmd_era5_tpu_torch.ops import matmul
from dmd_era5_tpu_torch.ops.matmul import MatmulBlock, matmul_block

F32, BF16 = torch.float32, torch.bfloat16
WEEK = 721 * 1440 * 15  # the ERA5 week's rows
YEAR = 181 * 360 * 15  # the hourly 1-degree year's
CAP = 232_448  # shared memory of one CTA
SOURCE = Path(matmul.__file__).parent / "csrc" / "matmul_tc.cuh"

# (label, M, K, N, dtype, center, width, columns, copy path, rows of w held, ring slots)
MAIN_PATH = [
    # K6
    ("16e_hankel_sketch", 721 * 1440, 97, 40, F32, False, 40, 1, "bulk", 128, 3),
    ("16d_streamed_block", 65_536, 97, 20, F32, False, 24, 1, "bulk", 128, 3),
    ("15c_UL", 2 * WEEK, 100, 24, F32, False, 24, 1, "tma", 104, 4),
    ("week_block_f32", 65_536, 168, 110, F32, False, 112, 1, "tma", 168, 4),
    ("week_block_bf16", 65_536, 168, 110, BF16, False, 112, 1, "tma", 176, 4),
    ("15c_lift_chunk", 1 << 21, 124, 100, F32, False, 112, 1, "tma", 128, 4),
    ("15a_block", 65_536, 168, 128, F32, False, 128, 1, "tma", 168, 2),
    ("18b_hankel_sketch", WEEK // 2, 168, 220, F32, False, 112, 2, "tma", 168, 4),
    # K1's sketch stage
    ("bench_bf16", 1 << 19, 512, 128, BF16, True, 128, 1, "tma", 512, 4),
    ("bench_f32_streamed", 1 << 19, 512, 128, F32, True, 128, 1, "tma", 32, 4),
    ("config2_n76", 721 * 1440, 97, 76, F32, True, 80, 1, "bulk", 128, 2),
    ("week_fit_f32", WEEK, 168, 128, F32, True, 128, 1, "tma", 168, 2),
    ("week_fit_bf16", WEEK, 168, 128, BF16, True, 128, 1, "tma", 176, 4),
    ("week_hankel_n256", WEEK, 168, 256, F32, True, 128, 2, "tma", 168, 2),
    ("year_streamed_n256", YEAR, 8760, 256, F32, True, 128, 2, "tma", 32, 4),
    ("d3_k2_n384", WEEK, 168, 384, BF16, True, 128, 3, "tma", 176, 4),
    ("19d_stacked_n40", 1296, 97, 40, F32, True, 40, 1, "bulk", 128, 3),
    ("19d_dmdc_n95", 6, 95, 95, F32, True, 112, 1, "elem", 96, 2),
    ("19c_dmdc_n128", 34, 166, 128, F32, True, 128, 1, "elem", 168, 2),
]


@pytest.mark.parametrize("label,m,k,n,dtype,center,width,columns,load,panel,stages", MAIN_PATH,
                         ids=[case[0] for case in MAIN_PATH])
def test_main_path_shapes_take_their_blocks(label, m, k, n, dtype, center, width, columns, load,
                                            panel, stages):
    block = matmul_block(m, k, n, dtype, center=center)
    assert (block.n, block.columns, block.load, block.panel, block.stages) == (
        width, columns, load, panel, stages)
    assert block.stream == (label in ("bench_f32_streamed", "year_streamed_n256"))


def _instantiated() -> set[tuple[str, str, int]]:
    """(dtype, copy path, width) of every instantiation in with_kind."""
    kinds = re.findall(r"Kind<(bf16|float), (TMA|BULK|ELEM), (\d+)>", SOURCE.read_text())
    assert kinds, "with_kind lists the instantiations"
    return {(dt, load.lower(), int(bn)) for dt, load, bn in kinds}


KS = [1, 8, 17, 24, 50, 97, 99, 100, 124, 166, 168, 169, 176, 177, 300, 512, 641, 705, 1030,
      8760]
NS = [1, 7, 20, 24, 25, 40, 41, 76, 80, 81, 100, 110, 112, 113, 128, 129, 220, 256, 384, 2048]


def _blocks():
    for k, n, dtype, center, aligned in itertools.product(KS, NS, (F32, BF16), (False, True),
                                                          (True, False)):
        yield k, n, dtype, center, aligned, matmul_block(1000, k, n, dtype, center, aligned)


def test_widths_are_instantiated_for_their_copy_path():
    kinds = _instantiated()
    for k, n, dtype, center, aligned, block in _blocks():
        if block.stream:
            assert (dtype, block.load, block.n) == (F32, "tma", 128), (k, n, block)
            continue
        dt = "float" if dtype == F32 else "bf16"
        assert (dt, block.load, block.n) in kinds, (k, n, dtype, center, aligned, block)


def test_copy_path_follows_alignment():
    for k, n, dtype, center, aligned, block in _blocks():
        itemsize = 4 if dtype == F32 else 2
        rows_aligned = k * itemsize % 16 == 0
        assert (block.load == "tma") == (aligned and rows_aligned), (k, n, dtype, aligned, block)
        if block.load == "bulk":
            assert dtype == F32 and aligned and not rows_aligned and block.n <= 80


def test_columns_cover_n():
    for k, n, dtype, center, aligned, block in _blocks():
        assert block.columns * block.n >= n > (block.columns - 1) * block.n, (k, n, block)
        if block.columns == 1 and block.load != "elem" and not block.stream:
            # the narrowest width of the table that holds n
            assert block.n == min(w for w in matmul._MM_WIDTHS if n <= w), (n, block)


def test_shared_memory_fits_and_the_ring_is_as_deep_as_it_allows():
    for k, n, dtype, center, aligned, block in _blocks():
        itemsize = 4 if dtype == F32 else 2
        smem = matmul._mm_smem(block.load, itemsize, k, block.n, block.panel, block.stages,
                               block.stream)
        assert block.smem == smem <= CAP, (k, n, block)
        assert 2 <= block.stages <= 4
        if block.stream:
            assert block.stages == 4
        elif block.load != "elem" and block.stages < 4:
            more = matmul._mm_smem(block.load, itemsize, k, block.n, block.panel,
                                   block.stages + 1)
            assert more > CAP, (k, n, block)


def test_w_rows_held_are_all_of_k_or_whole_panels():
    for k, n, dtype, center, aligned, block in _blocks():
        kstep, kc = (8, 32) if dtype == F32 else (16, 64)
        if block.stream:
            assert block.panel == 32 and k > 176
        elif block.load == "bulk":
            assert block.panel == -(-k // 32) * 32
        elif block.panel >= k:
            assert block.panel == -(-k // kstep) * kstep
        else:
            assert block.panel % kc == 0 and block.panel == (160 if dtype == F32 else 640)


def test_shared_memory_sum_at_the_streamed_block():
    """The sum spelled out where the ring is tightest: the week's block,
    w's f32 planes 168 x 112 x 8 bytes beside four 16 KB slots."""
    block = matmul_block(65_536, 168, 110, F32)
    assert block == MatmulBlock(112, 1, "tma", 168, 4, False,
                                1024 + 4 * 16_384 + 168 * 112 * 8 + 64 + 32 * 112 * 4 + 512)


def test_w_stream_bytes_at_the_year():
    """W's split chunks at the hourly year's N 256: 2 CTA columns x 274
    chunks of 32 rows x 128 columns x 8 bytes (18 MB)."""
    assert matmul._mm_w_stream_bytes(8760, 256) == 2 * 274 * 32 * 128 * 8
