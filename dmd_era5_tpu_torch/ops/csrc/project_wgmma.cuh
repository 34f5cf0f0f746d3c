// K3 on Hopper: the projection C = Y^T X (N x T, f32) of two tall row-major
// matrices over their M rows, X (M x T) and Y (M x N), f32 or bf16 each.
// project.cu launches it (project_launch) for ops/matmul.py::project; it
// replaces dmd_era5_tpu/ops/matmul.py::_project_kernel, whose precision it
// keeps: f32 x f32 as 3xTF32 (lo.hi + hi.lo + hi.hi, hi = tf32(a) rounded to
// nearest, atb_tc::split_tf32), bf16 x f32 as two products (the bf16
// operand is its own hi), bf16 x bf16 as one bf16 pass.
//
// Blocks shaped to C.  The MMA computes D = A^T B over a slab of rows, A on
// the m side (two warpgroups, m64 each: 128 of A's columns a block), B on
// the n side (N columns, a wgmma width).  The wrapper's block rule
// (ops/matmul.py::project_block) puts C's narrow side on n: Y on the m side
// and X on the n side (D a block of C), or, where N < T, X on the m side
// and Y on the n side (D a block of C^T, written back transposed).  An f32
// x bf16 pair keeps its f32 operand on the m side.  N is the narrow side
// rounded up to 8, or the narrow side cut into equal pieces of at most 88.
//
// Sums, as the other row-share kernels (row_share_atb_tc.cuh): a CTA owns
// one block of C and one share of the rows, which it walks in 128-row
// tiles.  A slab of rows is CH chains of MMAs (16 rows of two k8 steps for
// tf32, 32 rows of two k16 steps for bf16), each into its own outputs from
// zero, small terms first; each chain's sum is added into f32 accumulators
// rounded to nearest (the tensor core rounds its own sums toward zero), in
// row order.  Every accumulator goes into an f64 sum every 128 rows, the
// folds staggered as in K5 (gram_split_wgmma.cuh): slab q of each tile
// folds the accumulators i with i % SPT == q, so each sums exactly 128 rows
// in f32 between folds and the f64 work runs beside the MMAs.  A thread's
// N/2 f64 sums live in its registers (N <= 64) or in shared memory (N 72-88:
// N KB); CH is 2 where a thread's registers hold two chains' outputs beside
// the rest, else 1.  Each CTA writes its block's f64 sums once into its
// share's slice of the scratch, [N][T] per share; atb_tc::atb_reduce sums
// the shares in a fixed order, so C is identical from run to run.  No
// atomics.
//
// Loads.  A ring of RING slots, each one slab of A's block columns and of
// B's, on mbarriers.  Thread 0 issues each slab's copies with its bytes;
// the slot of slab s is refilled with slab s + RING once every thread is
// done with it (bf16: beside the next slab's MMAs; f32: after the slab's
// barrier; each placement measured faster for its type).  How an
// operand's slab comes, by the host's choice (project_modes):
//   BULK  the block spans all of the operand's columns (B's narrow side
//         when it fits one block; an f32 A when it has <= 128 columns) and its
//         base is 16-byte aligned: the slab is one contiguous span, one 1D
//         bulk copy (cp.async.bulk, R cols size bytes, always a multiple of
//         16), rows as they lie in memory.
//   TMA   the block spans part of the columns, or A is bf16: 2D boxes,
//         zero-filled past M and the columns; A in boxes of 128-byte rows
//         with the 128-byte swizzle (its fragments' reads free of bank
//         conflicts: a bf16 A's ldmatrix.trans of raw rows 256 bytes apart
//         hits one bank group; at K1's bf16 fit-step C, whose Yc has 128
//         columns, 5.63 ms raw against 3.79 swizzled,
//         scripts/torch_k4_times.py --c-blocks), an f32 B in
//         one unswizzled box of N columns; a bf16 x bf16 B always so, in
//         boxes of 64 columns with the 128-byte swizzle.
//   ELEM  a base that is not 16-byte aligned (a view), rows the TMA cannot
//         stride, and a BULK operand's ragged last slab: every thread loads
//         element by element into the same layout, zeros past M and the
//         columns.
// A's fragments come straight from the raw slot (f32: split into tf32 hi
// and lo in registers; bf16: ldmatrix.trans), at offsets fixed per thread.
// An f32 (or f32 x bf16) product's B is split once a CTA, a slab ahead,
// into two buffers of tf32 hi and lo planes of K-major core matrices, while
// the MMAs of the slab before it run; a bf16 x bf16 product's B is read by
// wgmma where the TMA put it (MN-major, swizzled, the transpose bit), with
// no split.  The threads meet at one named barrier a slab.
//
// What bounds it on an H100: 2 M N T flops against (M T + M N) element
// reads.  bf16 at the d = 3 pass and f32 at narrow C (15c, 16e, 18b, 18c)
// are bound by the bytes; the f32 year (N 256, T 8,760) by 3xTF32's three
// tensor-core passes.  The ring keeps up to 8 slabs of copies in flight an
// SM (HBM's latency times its rate over 132 SMs is ~32 KB); blocks next to
// one another in launch order share a row share, so an operand slab that
// several blocks read comes from L2.
//
// Tile table (what decided each choice; CUDA-event ms on an NVIDIA H100 80GB
// HBM3 at 700 W, scripts/torch_k3_phases.py and torch_k3_times.py, PERF.md):
//   m side        128    two warpgroups of m64
//   n widths      8-64 with the f64 sums in registers, 72-88 in shared
//                 memory (project.cu's RegWidths, SmemWidths): past 64 two
//                 chains' outputs and the f64 sums no longer fit a thread's
//                 registers, and one chain a slab read slower than shared
//                 sums; the narrow side in more pieces with the sums in
//                 registers reads slower too (d = 3 at 3 x 56: 13.5 against
//                 11.1; 18b at P = 2: 12.8 against 11.1)
//   narrow > 88   equal pieces of at most 88: d = 3 (T 168) two of 88
//   slab          CH chains of 16 (tf32) or 32 (bf16) rows
//   threads       256, no producer warp: a ninth warp caps every thread at
//                 168 registers (three warps on one SM sub-partition), and
//                 the chains spilled there
//   the year      f32 x f32 with a side of C past 2,048 (the hourly year's
//                 8,760) stays on the row-share mainloop (atb_wgmma_tf32x3,
//                 128 x 128 blocks): at an eighth of the year's rows, N 256,
//                 8.98 ms there against 9.13 here (3 x 88, shared sums)
//
// Ranges: any M, N and T; an f32 x bf16 pair with the f32 operand on the m
// side.  Ragged edges masked: rows past M are zero in every slot; columns
// past an operand's width only reach rows or columns of D that are not
// written.

#pragma once

#include <climits>
#include <utility>

#include "gram_split_wgmma.cuh"

namespace k3 {

using atb_tc::bf16;
using atb_tc::smem_u32;

constexpr int THREADS = 256;  // two warpgroups: the block's m side; 255 registers a thread
constexpr int BM = 128;  // A's columns a block
constexpr int MAX_RING = 8;
constexpr int SMEM_CAP = 232448;

enum Mode : int { BULK = 0, TMA = 1, ELEM = 2 };

// TA on the m side, TB on the n side; N the block's n; SSUMS: f64 sums in
// shared memory.
template <typename TA, typename TB, int N, bool SSUMS>
struct Cfg {
  static constexpr bool BF16 = sizeof(TA) == 2 && sizeof(TB) == 2;  // one bf16 pass
  static constexpr bool B_EXACT = !BF16 && sizeof(TB) == 2;        // bf16 B: its own hi
  static constexpr int NACC = N / 2;          // f32 accumulators a thread: m64 x nN
  static constexpr int H = BF16 ? 32 : 16;  // rows of one MMA chain: two k16 / k8 steps
  // chains a slab, each into its own MMA outputs: two where a thread's
  // registers hold them beside the f32 sums, the f64 sums (unless in
  // shared memory) and the A fragments, else one
  static constexpr int CH = 2 * NACC + NACC + (SSUMS ? 0 : 2 * NACC) + (BF16 ? 16 : 32) <= 200 ? 2 : 1;
  static constexpr int R = CH * H;            // rows a slab
  static constexpr int SPT = atb_tc::MT / R;  // slabs a 128-row tile
  static constexpr int A_BYTES = R * BM * (int)sizeof(TA);  // 8 or 16 KB
  // bf16 B: boxes of 64 columns x R rows, the 128-byte swizzle, that wgmma
  // reads as they land; f32 (or bf16 beside f32) B: R x N raw, split
  static constexpr int NB = BF16 ? (N + 63) / 64 : 0;
  static constexpr int B_BYTES = BF16 ? NB * R * 128 : (R * N * (int)sizeof(TB) + 1023) / 1024 * 1024;
  static constexpr int SLOT = A_BYTES + B_BYTES;
  // B's planes (f32 A): a chain's tf32 hi plane (H x N words) and lo plane
  // (none for a bf16 B); bf16 x bf16 has none
  static constexpr int PLANE = BF16 ? 0 : H * N * 4;
  static constexpr int HALF = (B_EXACT ? 1 : 2) * PLANE;  // a chain's planes
  static constexpr int BUF = CH * HALF;                   // a slab's
  static constexpr int PLANES = 2 * BUF;
  static constexpr int SUMS = SSUMS ? NACC * THREADS * 8 : 0;
  static constexpr int FREE = SMEM_CAP - 1024 - PLANES - SUMS - MAX_RING * 8;
  static constexpr int RING = FREE / SLOT < MAX_RING ? FREE / SLOT : MAX_RING;
  static constexpr int SMEM = 1024 + RING * SLOT + PLANES + SUMS + RING * 8;
  static constexpr int BOXC = 128 / (int)sizeof(TA);  // columns of one of A's swizzled boxes
  static constexpr int BOXB = R * 128;                // bytes of one
  static_assert(sizeof(TA) == 4 || BF16, "an f32 x bf16 pair has its f32 operand on the m side");
  static_assert(N % 8 == 0 && N >= 8 && N <= 128, "a wgmma width of the table");
  static_assert(RING >= 3, "slots in flight");
  static_assert(SMEM <= SMEM_CAP, "shared memory of one CTA");
};

// ------------------------------------------- warpgroup MMAs at width 8 C
//
// matmul_tc.cuh's TC_WGMMA (d (+)= a b, 64 x 8C, a in registers, b from a
// descriptor), at the widths of this kernel's table.

TC_WGMMA(1, 8)
TC_WGMMA(2, 16)
TC_WGMMA(3, 24)
TC_WGMMA(4, 32)
TC_WGMMA(5, 40)
TC_WGMMA(6, 48)
TC_WGMMA(7, 56)
TC_WGMMA(8, 64)
TC_WGMMA(9, 72)
TC_WGMMA(10, 80)
TC_WGMMA(11, 88)
TC_WGMMA(16, 128)

// One slab's 3xTF32 MMAs (f32 A): CH chains from zero, d[h] over rows
// 16 h .. 16 h + 15, each over its two k8 steps the small terms A_lo B_hi
// (+ A_hi B_lo unless B is bf16), then A_hi B_hi; the chains interleaved.
// ah[h][q], al[h][q]: A's fragments of chain h, k8 step q; pb: B's planes,
// chain h's hi plane at h half bytes, its lo plane `plane` bytes on; k8
// step q at 256 bytes a step.
template <bool B_EXACT, int CH, int NA>
__device__ __forceinline__ void mma_slab(float (&d)[CH][NA], const uint32_t (&ah)[CH][2][4],
                                         const uint32_t (&al)[CH][2][4], uint32_t pb, uint32_t half,
                                         uint32_t plane) {
  atb_tc::wgmma_fence();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int h = 0; h < CH; ++h) {
      const uint32_t b = pb + h * half + q * 256;
      wgmma_tf32(d[h], al[h][q], atb_tc::kmajor_desc(b), q == 0 ? 0 : 1);
      if constexpr (!B_EXACT) wgmma_tf32(d[h], ah[h][q], atb_tc::kmajor_desc(b + plane), 1);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int h = 0; h < CH; ++h) {
      wgmma_tf32(d[h], ah[h][q], atb_tc::kmajor_desc(pb + h * half + q * 256), 1);
    }
  }
  atb_tc::wgmma_commit();
}

// Descriptor of an MN-major bf16 operand in boxes of 64 columns x rows of
// 128 bytes with the 128-byte swizzle (as the TMA writes them): 8-row
// groups along K 1024 bytes apart (stride byte offset), boxes along N
// `box` bytes apart (leading byte offset).
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t saddr, uint32_t box) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(box >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// One slab's bf16 MMAs: CH chains from zero, d[h] over k16 steps 2 h and
// 2 h + 1 of the slab (16 rows, 2,048 bytes each); B at pb in swizzled
// boxes `box` bytes apart, read through the transpose bit.
template <int CH, int NA>
__device__ __forceinline__ void mma_slab(float (&d)[CH][NA], const uint32_t (&a)[CH][2][4],
                                         uint32_t pb, uint32_t box) {
  atb_tc::wgmma_fence();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int h = 0; h < CH; ++h) {
      wgmma_bf16(d[h], a[h][q], sw128_mn_desc(pb + (2 * h + q) * 2048, box), q == 0 ? 0 : 1);
    }
  }
  atb_tc::wgmma_commit();
}

// Raw bits of an operand's element type.
template <typename T>
using Bits = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;

struct Params {
  const void* a;     // the m side: Y, or X where transposed
  const void* b;     // the n side
  double* part;      // n_share x [N][T] f64
  long long m;       // rows
  int cols_a;        // A's columns (the m side's width)
  int cols_b;        // B's
  int trans;         // A is X: D is a block of C^T
  int mode_a;        // Mode
  int mode_b;
  int lda;           // A's raw row stride in a slot (elements), unless a_swz
  int ldb;           // B's (f32 A), unless bf16 x bf16 (swizzled boxes)
  int a_swz;         // A's slot holds swizzled boxes of 128-byte rows
  int n_share;
};

template <typename TA, typename TB, int N, bool SSUMS>
__global__ void __launch_bounds__(THREADS, 1)
    project_wgmma(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                  const Params p) {
  using C = Cfg<TA, TB, N, SSUMS>;
  constexpr int NACC = C::NACC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* planes = ring + C::RING * C::SLOT;
  double* sums = reinterpret_cast<double*>(planes + C::PLANES);  // SSUMS: [NACC][THREADS]
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + C::PLANES + C::SUMS);

  const int nbn = (p.cols_b + N - 1) / N;  // blocks along B
  const int m0 = (int)(blockIdx.x / nbn) * BM;
  const int n0 = (int)(blockIdx.x % nbn) * N;
  const int share = blockIdx.y;
  const long long n_tiles = (p.m + atb_tc::MT - 1) / atb_tc::MT;
  const long long my_tiles =
      share < n_tiles ? (n_tiles - share + p.n_share - 1) / p.n_share : 0;
  const int n_slabs = (int)(my_tiles * C::SPT);  // < 2^31 for M < 2^34
  // first row of slab s of this share: tile share + (s / SPT) n_share
  auto rows = [&](int s) {
    return (share + (long long)(s / C::SPT) * p.n_share) * atb_tc::MT + (s % C::SPT) * C::R;
  };

  const int ctid = threadIdx.x;
  if (ctid == 0) {
    for (int i = 0; i < C::RING; ++i) mm_tc::mbar_init(smem_u32(full + i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  using UA = Bits<TA>;
  using UB = Bits<TB>;
  // ELEM: row r0 + k of the block's columns into the slot's layout, zero
  // past M and the columns
  auto fill_a = [&](unsigned char* st, long long r0) {
    const UA* src = static_cast<const UA*>(p.a);
    const int w = p.a_swz ? BM : p.lda;
    for (int idx = ctid; idx < C::R * w; idx += THREADS) {
      const int k = idx / w, c = idx % w;
      const long long gr = r0 + k;
      const int gc = m0 + c;
      const UA v = gr < p.m && gc < p.cols_a ? src[gr * p.cols_a + gc] : UA(0);
      const int off = p.a_swz ? (c / C::BOXC) * C::BOXB + mm_tc::swz(k, (c % C::BOXC) * (int)sizeof(TA))
                              : (k * p.lda + c) * (int)sizeof(TA);
      *reinterpret_cast<UA*>(st + off) = v;
    }
  };
  auto fill_b = [&](unsigned char* st, long long r0) {
    const UB* src = static_cast<const UB*>(p.b);
    const int w = C::BF16 ? C::NB * 64 : p.ldb;
    for (int idx = ctid; idx < C::R * w; idx += THREADS) {
      const int k = idx / w, c = idx % w;
      const long long gr = r0 + k;
      const int gc = n0 + c;
      const UB v = gr < p.m && gc < p.cols_b ? src[gr * p.cols_b + gc] : UB(0);
      const int off = C::BF16 ? (c / 64) * C::R * 128 + mm_tc::swz(k, (c % 64) * 2)
                              : (k * p.ldb + c) * (int)sizeof(TB);
      *reinterpret_cast<UB*>(st + off) = v;
    }
  };
  // the bytes of one slab of each operand by bulk copy or TMA, and of one
  // row of a bulk-copied operand
  const long long a_row = (long long)p.cols_a * sizeof(TA), b_row = (long long)p.cols_b * sizeof(TB);
  uint32_t a_bytes = (uint32_t)(C::R * a_row);
  if (p.mode_a != BULK) {
    a_bytes = 0;
    for (int b = 0; b < BM / C::BOXC; ++b) a_bytes += m0 + b * C::BOXC < p.cols_a ? C::BOXB : 0;
  }
  uint32_t b_bytes = (uint32_t)(C::R * (p.mode_b == BULK ? b_row : N * (int)sizeof(TB)));
  if (C::BF16) {
    b_bytes = 0;
    for (int b = 0; b < C::NB; ++b) b_bytes += n0 + 64 * b < p.cols_b ? C::R * 128 : 0;
  }
  // slab s into slot `slot`: the ELEM parts by all threads, then one
  // thread arrives with the bytes of the copies and issues them
  auto produce = [&](int s, int slot) {
    unsigned char* st = ring + slot * C::SLOT;
    const long long r0 = rows(s);
    const bool whole = r0 + C::R <= p.m;
    const bool a_elem = p.mode_a == ELEM || (p.mode_a == BULK && !whole);
    const bool b_elem = p.mode_b == ELEM || (p.mode_b == BULK && !whole);
    if (a_elem) fill_a(st, r0);
    if (b_elem) fill_b(st + C::A_BYTES, r0);
    if (a_elem || b_elem) {
      atb_tc::fence_proxy_async();
      k5::consumer_sync();
    }
    if (ctid != 0) return;
    const uint32_t bar = smem_u32(full + slot);
    mm_tc::mbar_expect_tx(bar, (a_elem ? 0u : a_bytes) + (b_elem ? 0u : b_bytes));
    if (!a_elem) {
      if (p.mode_a == BULK) {
        mm_tc::bulk_load(smem_u32(st), static_cast<const unsigned char*>(p.a) + r0 * a_row, a_bytes, bar);
      } else {
#pragma unroll
        for (int b = 0; b < BM / C::BOXC; ++b) {
          if (m0 + b * C::BOXC < p.cols_a) {
            mm_tc::tma_load(smem_u32(st + b * C::BOXB), &amap, m0 + b * C::BOXC, (int)r0, bar);
          }
        }
      }
    }
    if (!b_elem) {
      if (p.mode_b == BULK) {
        mm_tc::bulk_load(smem_u32(st + C::A_BYTES), static_cast<const unsigned char*>(p.b) + r0 * b_row,
                         b_bytes, bar);
      } else if (C::BF16) {
#pragma unroll
        for (int b = 0; b < C::NB; ++b) {
          if (n0 + 64 * b < p.cols_b) {
            mm_tc::tma_load(smem_u32(st + C::A_BYTES + b * C::R * 128), &bmap, n0 + 64 * b, (int)r0, bar);
          }
        }
      } else {
        mm_tc::tma_load(smem_u32(st + C::A_BYTES), &bmap, n0, (int)r0, bar);
      }
    }
  };

  const int cw = ctid >> 5;
  const int lane = ctid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (cw >> 2) * 64 + (cw & 3) * 16;  // the warp's 16 rows of the block's m side

  // byte offset in a slot of A's element (k, m) of the block
  auto a_off = [&](int k, int m) {
    return p.a_swz ? (m / C::BOXC) * C::BOXB + mm_tc::swz(k, (m % C::BOXC) * (int)sizeof(TA))
                   : (k * p.lda + m) * (int)sizeof(TA);
  };
  // this thread's A fragments at the slab's first k-step: f32, register i:
  // row g (+8 for odd i) of the warp's 16, k = t (+4 for i >= 2); bf16: the
  // ldmatrix lane address, row lane % 8 of core matrix lane / 8.  k-step j
  // of the slab (chain j / 2) is j qstep bytes on (its rows; the swizzle
  // repeats every 8 rows).
  int offa[C::BF16 ? 1 : 4];
  if constexpr (C::BF16) {
    const int j = lane >> 3;
    offa[0] = a_off((j >> 1) * 8 + (lane & 7), row0 + (j & 1) * 8);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) offa[i] = a_off(t + 4 * (i >> 1), row0 + g + 8 * (i & 1));
  }
  const int qstep = C::H / 2 * (p.a_swz ? 128 : p.lda * (int)sizeof(TA));

  auto wait_full = [&](int s) {
    mm_tc::mbar_wait(smem_u32(full + s % C::RING), (uint32_t)((s / C::RING) & 1));
  };
  // B's raw slab s into the planes of buffer P (compile-time, so that the
  // planes' addresses fold), once it has landed: a unit is the four k of
  // one n that share 16 bytes of a K-major core matrix of its chain's
  // planes, (n / 8) (H / 4) + (k % H) / 4 at word (n % 8) 4 + k % 4 (lanes
  // on neighbouring n: one raw row, whole core-matrix rows).  bf16 x bf16:
  // the wait alone
  auto split_b = [&](int s, auto par) {
    constexpr int P = decltype(par)::value;
    wait_full(s);
    const unsigned char* raw = ring + (s % C::RING) * C::SLOT + C::A_BYTES;
    unsigned char* pl = planes + P * C::BUF;
    constexpr int UNITS = C::BF16 ? 0 : C::R * N / 4;
#pragma unroll
    for (int i = 0; i < (UNITS + THREADS - 1) / THREADS; ++i) {
      const int u = i * THREADS + ctid;
      if (UNITS % THREADS != 0 && u >= UNITS) break;
      if constexpr (C::BF16) {
        break;  // no split: wgmma reads B's boxes as they landed
      } else {
        const int n = u % N;
        const int kb = u / N;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = (4 * kb + e) * p.ldb + n;
          if constexpr (C::B_EXACT) {
            v[e] = n < p.ldb ? __uint_as_float((uint32_t)reinterpret_cast<const uint16_t*>(raw)[off] << 16)
                             : 0.f;
          } else {
            v[e] = n < p.ldb ? reinterpret_cast<const float*>(raw)[off] : 0.f;
          }
        }
        uint4 h, l;
        atb_tc::split_tf32<C::B_EXACT>(v[0], h.x, l.x);
        atb_tc::split_tf32<C::B_EXACT>(v[1], h.y, l.y);
        atb_tc::split_tf32<C::B_EXACT>(v[2], h.z, l.z);
        atb_tc::split_tf32<C::B_EXACT>(v[3], h.w, l.w);
        const int w = ((n >> 3) * (C::H / 4) + kb % (C::H / 4)) * 32 + (n & 7) * 4;
        unsigned char* hp = pl + kb / (C::H / 4) * C::HALF + w * 4;
        *reinterpret_cast<uint4*>(hp) = h;
        if constexpr (!C::B_EXACT) *reinterpret_cast<uint4*>(hp + C::PLANE) = l;
      }
    }
  };

  constexpr int CH = C::CH;
  float acc[NACC], d[CH][NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    acc[i] = 0.f;
#pragma unroll
    for (int h = 0; h < CH; ++h) d[h][i] = 0.f;
  }
  double rsum[SSUMS ? 1 : NACC];
  if constexpr (SSUMS) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) sums[i * THREADS + ctid] = 0.0;
  } else {
#pragma unroll
    for (int i = 0; i < NACC; ++i) rsum[i] = 0.0;
  }
  // accumulators i % SPT == Q into the f64 sums and from zero: slab Q of
  // each tile folds them, so each sums exactly SPT slabs (128 rows) in f32
  // between folds
  auto fold = [&](auto qc) {
    constexpr int Q = decltype(qc)::value;
#pragma unroll
    for (int i = Q; i < NACC; i += C::SPT) {
      if constexpr (SSUMS) {
        sums[i * THREADS + ctid] += (double)acc[i];
      } else {
        rsum[i] += (double)acc[i];
      }
      acc[i] = 0.f;
    }
  };
  auto fold_group = [&](int q) {
    k5::each_index([&](auto qc) {
      if (decltype(qc)::value == q) fold(qc);
    }, std::make_integer_sequence<int, C::SPT>{});
  };

  // the ring's first slabs; then slot s % RING is refilled with slab s +
  // RING beside the MMAs of slab s + 1, once every thread is done with slab s
  for (int s = 0; s < C::RING && s < n_slabs; ++s) produce(s, s);
  if (n_slabs > 0) split_b(0, std::integral_constant<int, 0>{});
  atb_tc::fence_proxy_async();  // the planes, to wgmma's reads
  k5::consumer_sync();
  int in_tile = 0;  // s % SPT
  const uint32_t plane0 = smem_u32(planes);
  // slab s (buffer P = s % 2): A's fragments from its slot, its MMAs, and
  // beside them the fold of group s % SPT and slab s + 1's split
  auto slab = [&](int s, auto par) {
    constexpr int P = decltype(par)::value;
    const unsigned char* sa = ring + (s % C::RING) * C::SLOT;
    const uint32_t pb = C::BF16 ? smem_u32(sa + C::A_BYTES) : plane0 + P * C::BUF;
    uint32_t ah[CH][2][4], al[CH][2][4];
#pragma unroll
    for (int h = 0; h < CH; ++h) atb_tc::hold(d[h]);
    if constexpr (C::BF16) {
#pragma unroll
      for (int j = 0; j < 2 * CH; ++j) {
        uint32_t(&a)[4] = ah[j >> 1][j & 1];
        atb_tc::ldsm_x4_trans(smem_u32(sa + offa[0] + j * qstep), a[0], a[1], a[2], a[3]);
      }
      mma_slab(d, ah, pb, C::R * 128);
    } else {
#pragma unroll
      for (int j = 0; j < 2 * CH; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          atb_tc::split_tf32(*reinterpret_cast<const float*>(sa + offa[i] + j * qstep),
                             ah[j >> 1][j & 1][i], al[j >> 1][j & 1][i]);
        }
      }
      mma_slab<C::B_EXACT>(d, ah, al, pb, C::HALF, C::PLANE);
    }
    // bf16: slot (s - 1) % RING, free since the last barrier, refilled
    // beside the MMAs (f32: after the barrier below; each measured faster)
    if (C::BF16 && s >= 1 && s - 1 + C::RING < n_slabs) {
      produce(s - 1 + C::RING, (s - 1) % C::RING);  // the copies
    }
    fold_group(in_tile);  // the staggered fold
    if (s + 1 < n_slabs) {
      split_b(s + 1, std::integral_constant<int, 1 - P>{});  // the split
    }
    atb_tc::fence_proxy_async();
    atb_tc::wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < CH; ++h) {
      atb_tc::hold(d[h]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        atb_tc::hold(ah[h][q]);
        if constexpr (!C::BF16) atb_tc::hold(al[h][q]);
      }
    }
#pragma unroll
    for (int h = 0; h < CH; ++h) {  // the chains in row order
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += d[h][i];
    }
    if (++in_tile == C::SPT) in_tile = 0;
    k5::consumer_sync();  // slab s + 1 split; slab s's slot and planes done with
    if (!C::BF16 && s + C::RING < n_slabs) {
      produce(s + C::RING, s % C::RING);  // the copies
    }
  };
  for (int s = 0; s < n_slabs; s += 2) {
    slab(s, std::integral_constant<int, 0>{});
    if (s + 1 < n_slabs) slab(s + 1, std::integral_constant<int, 1>{});
  }
  k5::each_index(fold, std::make_integer_sequence<int, C::SPT>{});  // the last folds

  // accumulator i: row g (+8 for i % 4 >= 2) of the warp's 16 on the m
  // side, column 8 (i / 4) + 2 t + i % 2 on the n side; into the share's
  // [N][T] slice, transposed where A is X
  auto sum_of = [&](int i) {
    if constexpr (SSUMS) {
      return sums[i * THREADS + ctid];
    } else {
      return rsum[i];
    }
  };
  double* dst = p.part + (size_t)share * p.cols_a * p.cols_b;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int mi = m0 + row0 + g + ((i & 3) >> 1) * 8;
    const int ni = n0 + (i >> 2) * 8 + 2 * t + (i & 1);
    const double v = sum_of(i);
    if (mi < p.cols_a && ni < p.cols_b) {
      dst[p.trans ? (size_t)ni * p.cols_a + mi : (size_t)mi * p.cols_b + ni] = v;
    }
  }
}

// ------------------------------------------------------------ host side

// How each operand's slabs come (the note above), into p.
template <typename TA, typename TB, int N, bool SSUMS>
void project_modes(Params& p) {
  using C = Cfg<TA, TB, N, SSUMS>;
  const bool tma_rows = p.m <= INT_MAX;
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const int round8_a = (p.cols_a + 7) / 8 * 8;
  const int round8_b = (p.cols_b + 7) / 8 * 8;
  if (p.cols_a <= BM && !C::BF16) {  // one block spans f32 A: slabs are contiguous spans
    p.a_swz = 0;
    p.mode_a = aligned(p.a) ? BULK : ELEM;
    p.lda = p.mode_a == BULK ? p.cols_a : round8_a;
  } else {
    p.a_swz = 1;
    p.lda = BM;
    p.mode_a = aligned(p.a) && (p.cols_a * (long long)sizeof(TA)) % 16 == 0 && tma_rows ? TMA : ELEM;
  }
  if (C::BF16) {  // always boxes of 64 columns: TMA, or ELEM into their layout
    p.ldb = 0;
    p.mode_b = aligned(p.b) && p.cols_b % 8 == 0 && tma_rows ? TMA : ELEM;
  } else if (p.cols_b <= N) {
    p.mode_b = aligned(p.b) ? BULK : ELEM;
    p.ldb = p.mode_b == BULK ? p.cols_b : round8_b;
  } else {
    p.ldb = N;
    p.mode_b = aligned(p.b) && (p.cols_b * (long long)sizeof(TB)) % 16 == 0 && tma_rows ? TMA : ELEM;
  }
}

template <typename T>
CUtensorMapDataType tma_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A's map (boxes of BOXC columns x R rows, 128-byte swizzle) or B's (N x R,
// no swizzle), over the operand's M x cols.
template <typename T>
cudaError_t encode(CUtensorMap* map, const void* base, long long m, int cols, int box_cols, int box_rows,
                   bool swizzle) {
  const mm_tc::EncodeTiled enc = mm_tc::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      enc(map, tma_type<T>(), 2, const_cast<void*>(base), dims, strides, box, unit,
          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TA, typename TB, int N, bool SSUMS>
cudaError_t allow() {
  return cudaFuncSetAttribute(project_wgmma<TA, TB, N, SSUMS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<TA, TB, N, SSUMS>::SMEM);
}

// C (n x t, f32) = Y^T X through the blocks of N columns of B: the kernel,
// then atb_reduce, on `stream`; p.part holds n_share n t doubles, with p's
// a, b, part, m, cols_a, cols_b, trans and n_share set.  Returns a
// cudaError_t code.
template <typename TA, typename TB, int N, bool SSUMS>
cudaError_t launch(Params p, float* c, int n, int t, cudaStream_t stream) {
  using C = Cfg<TA, TB, N, SSUMS>;
  const long long mb = (p.cols_a + BM - 1) / BM;
  const long long nb = (p.cols_b + N - 1) / N;
  if (p.m < 1 || p.cols_a < 1 || p.cols_b < 1 || p.n_share < 1 || p.n_share > 65535 ||
      mb * nb > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  project_modes<TA, TB, N, SSUMS>(p);
  CUtensorMap amap{}, bmap{};
  cudaError_t err = cudaSuccess;
  if (p.mode_a == TMA) err = encode<TA>(&amap, p.a, p.m, p.cols_a, C::BOXC, C::R, true);
  if (err == cudaSuccess && p.mode_b == TMA) {
    err = C::BF16 ? encode<TB>(&bmap, p.b, p.m, p.cols_b, 64, C::R, true)
                  : encode<TB>(&bmap, p.b, p.m, p.cols_b, N, C::R, false);
  }
  if (err == cudaSuccess) err = allow<TA, TB, N, SSUMS>();
  if (err != cudaSuccess) return err;
  project_wgmma<TA, TB, N, SSUMS><<<dim3((unsigned)(mb * nb), p.n_share), THREADS, C::SMEM, stream>>>(
      amap, bmap, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)n * t;
  atb_tc::atb_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(p.part, c, p.n_share, n, t, 0);
  return cudaGetLastError();
}

// CTAs of the kernel that fit one SM at once, into *out.
template <typename TA, typename TB, int N, bool SSUMS>
cudaError_t ctas_per_sm(int* out) {
  const cudaError_t err = allow<TA, TB, N, SSUMS>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, project_wgmma<TA, TB, N, SSUMS>, THREADS,
                                                       Cfg<TA, TB, N, SSUMS>::SMEM);
}

}  // namespace k3
