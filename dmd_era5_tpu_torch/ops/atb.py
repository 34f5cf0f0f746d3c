"""The row-share Gram kernel on the card: K4 and the G stages of K1 and
K2.

``csrc/atb.cu`` on ``csrc/atb_wgmma.cuh`` computes G = A^T A over the rows
of a tall row-major panel, f64-grade and exactly symmetric, on Hopper's
warpgroup MMAs.  This module holds its block table (:func:`gram_block`:
the width of the blocks on the MMA's n side, the blocks a row share,
where their f64 sums live) and the launches that ``ops/qr_panel.py::gram``
(K4 at ``"highest"``) and ``ops/matmul.py``'s K1 and K2 make through it.
K1's C stage is K3's kernel (``ops/matmul.py::project_block``).  The
launches here count nothing: each caller counts its own kernel.  Nothing
here runs on a CPU tensor; the callers take their plain versions there.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from dmd_era5_tpu_torch.ops._occupancy import resident_ctas, wave_row_shares

__all__ = ["AtbBlock", "gram_block", "upper_blocks", "gram_cuda", "copy_modes"]

BM = 128  # G's rows a block: the MMA's m side, two warpgroups of m64
MT = 128  # rows of a tile: a call of at most MT rows has one row share (one launch)
REG_N = 64  # widest block whose f64 sums stay in registers
N_MAX = 88  # widest block of the table (csrc/atb.cu's SmemWidths)
# K4's (and K1's and K2's G's) table, by K, from device ms on an H100 80GB
# HBM3 at 700 W, in turns with the row-share mainloop that was K4's before
# (scripts/torch_k4_times.py, torch_k4_phases.py; PERF.md):
#   K <= GRAM_ONE_BLOCK      one block of K rounded up to 8 (14c's K 82:
#                            11.41 ms against the row-share mainloop's 14.73)
#   to 128, and 129-192 bf16 the upper blocks of the width of _GRAM_WIDTHS
#                            that leaves the fewest MMA columns, the wider on
#                            a tie, f64 sums in registers (bf16 at K 128: 2.61
#                            against 3.58; d = 3's K 384: 19.8 against 23.8)
#   129-192, f32             the same widths, the f64 sums in shared memory and
#                            two CTAs an SM (the week's X: 18.47 against 20.49)
#   f32 past GRAM_ONE_BLOCK to 128, and past 192, at more rows than one tile
#                            the row-share mainloop (row_share_atb_tc.cuh,
#                            128 x 128 blocks), which reads faster there (the
#                            fit step's Yc at K 128: 7.17 against 8.68 at this
#                            mainloop's best; K1's G at N 256: 23.5 against
#                            28.5; the week's Y at K 110: 7.58 against 7.83)
# A Gram of one m block (K <= 128) refills a slot beside the next slab's
# MMAs (early): 8.68 against 9.4 at the fit step's K 128, 7.83 against 8.8
# at the week's Y; more m blocks read slower so (18.4 against 17.9 at X).
GRAM_ONE_BLOCK = 88
_GRAM_WIDTHS = (32, 40, 48, 56, 64)
_ROW_SHARE_EDGE = 128  # the row-share mainloop's blocks


class AtbBlock(NamedTuple):
    """The kernel's blocks for one Gram: ``n`` is the blocks' width on the
    n side (their m side is ``BM``), ``m_blocks`` and ``n_blocks`` how
    many of each span G, ``blocks`` the CTAs a row share (those holding an
    entry r <= c), ``sums`` where their f64 sums live: ``"registers"``,
    ``"shared"``, or ``"shared2"`` (in shared memory, two CTAs an SM);
    ``mainloop`` ``"atb_wgmma"`` or, for an f32 Gram where it reads faster,
    ``"row_share"`` (128 x 128 blocks); ``early``: a slot is refilled
    beside the next slab's MMAs."""

    n: int
    m_blocks: int
    n_blocks: int
    blocks: int
    sums: str  # "registers", "shared" or "shared2"
    mainloop: str = "atb_wgmma"
    early: bool = False


def _round8(v: int) -> int:
    return 8 * -(-v // 8)


def _sums(n: int) -> str:
    return "registers" if n <= REG_N else "shared"


def upper_blocks(k: int, n: int, bm: int = BM) -> int:
    """Blocks of bm x n of a k x k Gram matrix that hold an entry r <= c:
    block (i, j) for j >= i bm // n (csrc/atb_wgmma.cuh::block_of)."""
    n_blocks = -(-k // n)
    return sum(n_blocks - i * bm // n for i in range(-(-k // bm)))


def gram_block(k: int, dtype: torch.dtype = torch.float32, m: int | None = None) -> AtbBlock:
    """K4's (and K1's and K2's G stage's) block for the k-wide Gram matrix
    of an (m, k) panel of ``dtype``: the table above.  ``m`` (None: many
    rows) tells a call of one tile, which always takes this mainloop (one
    launch)."""
    return _gram_block(k, dtype, m is not None and m <= MT)


@functools.lru_cache(maxsize=1024)
def _gram_block(k: int, dtype: torch.dtype, one_tile: bool) -> AtbBlock:
    f32 = dtype == torch.float32
    if f32 and not one_tile and (GRAM_ONE_BLOCK < k <= BM or k > 192):
        e = _ROW_SHARE_EDGE
        return AtbBlock(e, -(-k // e), -(-k // e), upper_blocks(k, e, e), "shared", "row_share")
    if k <= GRAM_ONE_BLOCK:
        n = _round8(k)
        return AtbBlock(n, 1, 1, 1, _sums(n), early=True)
    cost, _, n = min((upper_blocks(k, w) * w, -w, w) for w in _GRAM_WIDTHS)
    sums = "shared2" if f32 and not one_tile and k > BM else "registers"
    return AtbBlock(n, -(-k // BM), -(-k // n), upper_blocks(k, n), sums, early=k <= BM)


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from dmd_era5_tpu_torch.ops._build import load_kernel_library

        lib = load_kernel_library("atb")
        ptr, flag = ctypes.c_void_p, ctypes.c_int
        # a, per-share f64 partials (or null), G, m, k, a_bf16, block n, where
        # the f64 sums live, early, n_share, stream
        lib.atb_launch.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, flag, flag, flag, flag, flag,
                                   flag, ptr]
        lib.atb_launch.restype = ctypes.c_int
        # a_bf16, block n, where the f64 sums live, &out
        lib.atb_ctas_per_sm.argtypes = [flag, flag, flag, ptr]
        lib.atb_ctas_per_sm.restype = ctypes.c_int
        # a, m, k, a_bf16, block n, where the f64 sums live, &mode_a, &mode_b
        lib.atb_modes.argtypes = [ptr, ctypes.c_longlong, flag, flag, flag, flag, ptr, ptr]
        lib.atb_modes.restype = ctypes.c_int
        # the row-share mainloop's f32 Gram: a, per-share f64 partials, G, m, k, n_share, stream
        lib.atb_row_share_gram_launch.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, flag, flag, ptr]
        lib.atb_row_share_gram_launch.restype = ctypes.c_int
        lib.atb_row_share_ctas_per_sm.argtypes = [ptr]
        lib.atb_row_share_ctas_per_sm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


SUMS_KINDS = ("registers", "shared", "shared2")  # csrc/atb_wgmma.cuh's SumsKind
MODES = ("bulk", "tma", "elem")  # project_wgmma.cuh's k3::Mode


def _flags(a: torch.Tensor, block: AtbBlock) -> tuple:
    return int(a.dtype == torch.bfloat16), block.n, SUMS_KINDS.index(block.sums)


def row_shares(a: torch.Tensor, block: AtbBlock) -> int:
    """Row shares of a launch on ``a``: whole waves of the kernel's resident
    CTAs over ``block.blocks`` blocks, its f64 scratch (K^2 doubles a
    share) within 1 GiB.  One share: one launch, no scratch."""
    if block.mainloop == "row_share":
        wave = resident_ctas(a.device, ("atb", "row_share"),
                             lambda out: _library().atb_row_share_ctas_per_sm(out))
    else:
        flags = _flags(a, block)
        wave = resident_ctas(a.device, ("atb", *flags),
                             lambda out: _library().atb_ctas_per_sm(*flags, out))
    return wave_row_shares(wave, block.blocks, a.shape[0], 8 * a.shape[1] ** 2)


def copy_modes(a: torch.Tensor, block: AtbBlock) -> tuple[str, str]:
    """How the kernel would bring in ``a``'s slabs in ``block``, as the
    library decides it (``csrc/atb.cu::atb_modes``): of the blocks' rows
    and of their columns where these are not read from the rows' slab,
    each ``"bulk"`` (one copy a slab), ``"tma"`` (TMA boxes) or ``"elem"``
    (element by element)."""
    mode_a, mode_b = ctypes.c_int(-1), ctypes.c_int(-1)
    rc = _library().atb_modes(a.data_ptr(), a.shape[0], a.shape[1], *_flags(a, block),
                              ctypes.byref(mode_a), ctypes.byref(mode_b))
    if rc != 0:
        raise RuntimeError(f"atb modes: CUDA error {rc}")
    return MODES[mode_a.value], MODES[mode_b.value]


def gram_cuda(a: torch.Tensor, block: AtbBlock | None = None, n_share: int | None = None
              ) -> torch.Tensor:
    """G = A^T A (K, K) f32 of a (M, K) f32 or bf16 on the card, exactly
    symmetric, in ``block`` (by default :func:`gram_block`'s; a
    ``"row_share"`` block takes f32 A only) over ``n_share`` row shares
    (by default :func:`row_shares`).  The host work of a small call is
    kept short: its kernel takes a few microseconds."""
    if not a.is_contiguous():
        raise ValueError("a must be contiguous (row-major M x K)")
    (m, k), dev = a.shape, a.device
    block = block or gram_block(k, a.dtype, m)
    n_share = n_share or row_shares(a, block)
    on_current = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if on_current else torch.cuda.device(dev):
        g = torch.empty((k, k), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if block.mainloop == "row_share":  # f32: the scratch and a reduction always
            part = torch.empty((n_share, k, k), dtype=torch.float64, device=dev)
            rc = _library().atb_row_share_gram_launch(a.data_ptr(), part.data_ptr(), g.data_ptr(),
                                                      m, k, n_share, stream)
        else:
            # one share writes G from its f64 sums; more go through the scratch
            part = (None if n_share == 1 else
                    torch.empty((n_share, k, k), dtype=torch.float64, device=dev))
            rc = _library().atb_launch(
                a.data_ptr(), None if part is None else part.data_ptr(), g.data_ptr(), m, k,
                *_flags(a, block), int(block.early), n_share, stream,
            )
    if rc != 0:
        raise RuntimeError(f"atb kernel: CUDA error {rc}")
    # part is released on return while the kernels may still run: the
    # caching allocator hands its memory only to later work on this stream
    return g
