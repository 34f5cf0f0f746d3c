// The streamed block product out = x @ w on Hopper's tensor cores, summed
// in f32: the mainloop of K6 (matmul.cu) and of K1's sketch stage
// (sketch_center_gram_project.cu, with the CENTER epilogue).  The product's
// precision follows the operand type:
//
//   f32 x f32 -> 3xTF32, the counterpart of Precision.HIGHEST: hi = tf32(a)
//                rounded to nearest, lo = a - hi from the ROUNDED hi (the
//                tensor core drops the 13 low bits it is handed), and
//                lo.hi + hi.lo + hi.hi summed in f32 (atb_tc::split_tf32,
//                as K3).  One TF32 pass (~1e-3) would be another function.
//   bf16 x bf16 -> one bf16 pass (DEFAULT): products exact in f32.
//
// The output is f32, or bf16 rounded from the f32 sum.
//
// - Persistent CTAs, about one an SM (the wrapper sizes the grid from the
//   occupancy query), in columns of BN output columns: 112 for K6 (N 110
//   padded to the next valid wgmma width, not to 128), 112 or 128 for K1
//   (its table, sketch_center_gram_project.cu).  A CTA loads its column of w
//   once, splits it into K-major tf32 hi and lo planes (transposed on the
//   way in, as K3's B) or, for bf16, stores it MN-major for wgmma's
//   transpose bit (as K3-bf16's B), and then walks 128-row tiles of x,
//   grid-stride, until the rows run out.
// - x is the A operand: its rows are K-contiguous, as tf32 wgmma wants.  It
//   streams through a ring of STAGES chunks of 128 rows x 128 bytes (32 f32
//   or 64 bf16 columns of K), each one TMA copy with the 128-byte swizzle,
//   whose out-of-range rows and columns the copy engine fills with zeros.
//   One thread keeps up to STAGES chunks in flight; a chunk's slot is refilled
//   as soon as every warp has its A fragments in registers, while that
//   chunk's MMAs run.  Rows whose stride or base is not 16-byte aligned
//   (K % 4 for f32, K % 8 for bf16) take the element-wise instantiation,
//   which fills the same swizzled slots by ordinary loads.
// - Two consumer warpgroups own rows 0-63 and 64-127 of a tile.  f32: each
//   warp reads its 16 rows' fragments from the swizzled chunk (conflict
//   free), splits them in registers, and issues per chunk the small terms
//   A_lo B_hi + A_hi B_lo of its four k8 steps, then A_hi B_hi
//   (m64n112k8); bf16: ldmatrix fragments, four m64n112k16 MMAs.
// - Accumulation: the tensor core rounds its sums toward zero, so the MMAs
//   of each chunk (4 k-steps; every k-step in K1's bf16 sketch) start from
//   zero and their sum is added into f32 accumulators rounded to nearest (chained over a tile instead, out
//   read 2.2-3.8x the plain f32 product's error against the f64 product:
//   the `chained` variant of scripts/torch_k6_phases.py, PERF.md).
// - Epilogue: a tile's sums go through shared memory 32 rows at a time, so
//   that each warp stores 128 contiguous bytes of one row of out (f32 or
//   bf16, masked on ragged M and N), while the ring already holds the next
//   tile's first chunks.
//
// What the card showed (H100, phase 9a's shapes; scripts/torch_k6_phases.py
// times variants without one phase each, PERF.md has the numbers): the
// phases of a CTA do not overlap one another -- the x stream, the 3xTF32
// MMAs (at the TF32 peak) and the stores of out add up, and a ring of 2
// chunks reads as 4 does.  With one CTA an SM (the f32 planes take 150.5
// KB) nothing else runs beside them; warp-specialised stores or a second
// CTA an SM need the shared memory that w takes.  Stores straight from the
// accumulator registers (32 bytes of each of 8 rows a warp) read slower
// than the staged ones, and w's staging with its loads unrolled 8 deep
// faster than rolled.
//
// Shared-memory budget (227 KB a CTA): the ring takes 4 x 16 KB = 64 KB,
// the staged rows of out 14 KB and K1's row means 0.5 KB; w takes K x 112 x 8 bytes for f32 (hi and
// lo planes: 150.5 KB at K 168) and K x 112 x 2 for bf16 (37.6 KB), K padded
// with zeros to the MMA's depth (8 tf32, 16 bf16) in shared memory only.
// So w is resident for K <= 168 (f32) or 672 (bf16); past that it is
// walked in panels of 160 or 640 rows of K, restaged once a tile and panel
// (from L2: w is small).  N > BN takes more CTA columns.  At BN 128 the
// f32 planes take 168 KB at K 168 and the staged rows 16 KB, so the ring
// is 2 chunks deep (Tile): w resident for K <= 176 (f32) or 704 (bf16).
//
// Streamed w (STREAM; K1's and K2's sketch past the resident depth, f32 x
// by TMA, BN 128): a panel's restage is two CTA-wide barriers and a tf32
// split of as many elements of w as the tile streams of x, and took 40% of
// the sketch at the hourly year (T 8,760).  So split_w splits w once a call
// into device memory (w_stream_bytes: 18 MB at the year's N 256, held in
// L2), as the chunks the kernel reads -- per CTA column and KC rows of K,
// the hi plane then the lo plane, each in stage_w's layout at kw = KC --
// and each chunk of w rides the ring beside its chunk of x: one bulk copy
// of 32 KB on the same barrier as x's 16 KB, four slots (192 KB).  No
// barrier, split or restage stands between the MMAs; a slot is refilled
// once the MMAs that read its w have completed.  The product is the held
// one bit for bit (the same splits, the same MMA order).
//
// Tile table (each choice and what decided it on an H100; it stands in for
// the TPU tile sweep of the nearest product, scripts/kernel_tune.py:218-225):
//
//   rows a tile       128   two m64 warpgroups; 512 tiles of the streamed
//                           block over 132 SMs fill 97% of 4 rounds
//   columns a CTA     112   N 110 -> one n112 MMA, 2% padding (n128: 14%);
//                           K1's sketch: 112 or 128 by N (its table)
//   chunk of K        128 B the 128-byte swizzle's row; 4 MMA k-steps
//   ring              4     64 KB beside the 150.5 KB of f32 planes; 2
//                           reads the same
//   MMA chain         4     k-steps between restarts from zero (one chunk):
//                           chained over a tile, out read 2.2-3.8x the
//                           plain f32 product's error against the f64
//                           product, restarted 0.32-0.42x (chip_smoke.py;
//                           scripts/torch_k6_phases.py's `chained`)
//   rows staged       32    the 14 KB left beside the f32 planes
//   threads           256   two consumer warpgroups, no producer warp: one
//                           thread issues the copies between its MMAs
//
// K1's epilogue (CENTER): every CTA sums its tile's rows of x (and their
// squares) from the chunks already in the ring, between its MMAs' issue and
// the slot's refill, half a row a thread; at the tile's end the row means go
// into 512 bytes of shared memory beside the staged rows, and each stored
// element is out - __fmul_rn(mean, colw[c]) rounded to out's dtype.  Every
// CTA column recomputes the sums (T adds a row) rather than wait on another;
// only column 0 stores them, as (m, 2) or as its CTA's f64 sums of rs^2 and
// ss, which the caller sums in CTA order.
//
// Ranges: any M, K and N; x row-major and contiguous, w row-major.

#pragma once

#include <cuda.h>

#include <atomic>

#include "row_share_atb_tc.cuh"

namespace mm_tc {


using atb_tc::bf16;
using atb_tc::smem_u32;

constexpr int THREADS = 256;
constexpr int BM = 128;                        // rows of x a tile
constexpr int CHUNK_ROW = 128;                 // bytes of a chunk's row: the swizzle's
constexpr int STAGE_BYTES = BM * CHUNK_ROW;    // 16 KB
constexpr int SMEM_CAP = 232448;               // shared memory of one CTA
constexpr int ALIGN = 1024;                    // the 128-byte swizzle's period
constexpr int OUT_ROWS = 32;                   // rows of a tile staged at once for the stores
constexpr int MU_BYTES = BM * 4;               // the tile's row means (K1's epilogue)

// What depends on the columns of out a CTA: BN 112 (K6: N 110 in one
// column) or 128 (K1: N 128 in one column, 256 in two), whose f32 planes
// leave room for a 2-deep ring only; and on whether w streams (STREAM: its
// chunks ride the ring beside x's, 4 deep).
template <int BN_, bool STREAM = false>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int NACC = BN / 2;                            // f32 accumulators a thread
  static constexpr int STAGES = STREAM || BN == 112 ? 4 : 2;     // x chunks in the ring
  static constexpr int BAR_BYTES = STAGES * 8;
  static constexpr int OUT_BYTES = OUT_ROWS * BN * 4;  // 14 or 16 KB
  static constexpr int FREE =
      SMEM_CAP - ALIGN - STAGES * STAGE_BYTES - BAR_BYTES - OUT_BYTES - MU_BYTES;  // for w
  static_assert(BN == 112 || BN == 128, "a wgmma width the kernel has");
};

template <typename T, int BN>
struct Cfg;
template <int BN>
struct Cfg<float, BN> {
  static constexpr int KC = CHUNK_ROW / 4;   // columns of K a chunk
  static constexpr int KSTEP = 8;            // K of one MMA
  static constexpr int ROW_BYTES = 8 * BN;   // a row of K in the hi and lo planes
  static constexpr int PANEL = 160;          // rows of K a panel, where K does not fit
};
template <int BN>
struct Cfg<bf16, BN> {
  static constexpr int KC = CHUNK_ROW / 2;
  static constexpr int KSTEP = 16;
  static constexpr int ROW_BYTES = 2 * BN;
  static constexpr int PANEL = 640;
};

// Deepest K of w resident at once, a multiple of the MMA's depth.
template <typename T, int BN>
constexpr int kmax() {
  return Tile<BN>::FREE / Cfg<T, BN>::ROW_BYTES / Cfg<T, BN>::KSTEP * Cfg<T, BN>::KSTEP;
}
static_assert(kmax<float, 112>() == 168 && kmax<bf16, 112>() == 672 && kmax<float, 128>() == 176 &&
                  kmax<bf16, 128>() == 704,
              "the budget in the note");
static_assert(Cfg<float, 112>::PANEL % Cfg<float, 112>::KC == 0 &&
                  Cfg<float, 112>::PANEL <= kmax<float, 112>() &&
                  Cfg<bf16, 112>::PANEL % Cfg<bf16, 112>::KC == 0 &&
                  Cfg<bf16, 112>::PANEL <= kmax<bf16, 112>(),
              "a panel is whole chunks and fits");

// Rows of K of w a CTA holds: all of K, padded to the MMA's depth, where it
// fits; else a panel.
template <typename T, int BN>
int panel_rows(int k) {
  constexpr int S = Cfg<T, BN>::KSTEP;
  const int padded = (k + S - 1) / S * S;
  return padded <= kmax<T, BN>() ? padded : Cfg<T, BN>::PANEL;
}

// Shared memory of a CTA holding `rows` of K of w: the planes, or with
// STREAM a chunk of KC rows in each slot of the ring.
template <typename T, int BN, bool STREAM = false>
constexpr int smem_bytes(int rows) {
  using L = Tile<BN, STREAM>;
  return ALIGN + L::STAGES * STAGE_BYTES + (STREAM ? L::STAGES : 1) * rows * Cfg<T, BN>::ROW_BYTES +
         L::BAR_BYTES + L::OUT_BYTES + MU_BYTES;
}
static_assert(smem_bytes<float, 128, true>(Cfg<float, 128>::KC) <= SMEM_CAP,
              "four slots of x's and w's chunks fit");

// Bytes of w's chunks as the streamed kernel reads them (split_w): for each
// CTA column and chunk of KC rows of K, its tf32 hi plane, then its lo plane.
template <int BN>
long long w_stream_bytes(int k, int n) {
  using C = Cfg<float, BN>;
  return (long long)((n + BN - 1) / BN) * ((k + C::KC - 1) / C::KC) * C::KC * C::ROW_BYTES;
}

// What K1's epilogue (sketch_center_gram_project.cu) takes beside out.
struct CenterArgs {
  const float* colw;      // column sums of w (n)
  float* stats;           // (m, 2): row sums and sums of squares of x; or null
  double* st_part;        // (gridDim.x, 2): a CTA's sums of rs^2 and of ss; or null
  float inv_t;            // 1 / t_valid, 0 without centring
  int square_in_storage;  // ss sums x * x rounded to x's dtype (stats_col)
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Until the phase of bar with this parity has completed.  A copy that never
// lands traps the kernel after ~2^35 clocks (~20 s) instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}
// `bytes` contiguous bytes at src into shared memory at dst, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Box (c0, c1) of the 2-D map into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Shared-memory descriptor without swizzle: leading and stride byte offsets.
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (+)= a b, 64 x 112: a a warp's 16 rows in registers (the m16n8k8 tf32 or
// m16n8k16 bf16 fragment), b from a descriptor; d as 14 n8 tiles of the
// m16n8 accumulator layout.  scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_tf32(float (&d)[56], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
// B MN-major, read through the transpose bit
__device__ __forceinline__ void wgmma_bf16(float (&d)[56], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The same at n 128: atb_tc's, the same instructions.
using atb_tc::wgmma_bf16;
using atb_tc::wgmma_tf32;

// Registers that an in-flight wgmma reads or writes: atb_tc::hold, and a
// fragment of each k-step of a chunk.
using atb_tc::hold;
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) atb_tc::hold(r[i]);
}

// Byte offset of element (r, c) of a chunk: 128-byte rows, 16-byte runs
// swizzled by the row's index mod 8 (CU_TENSOR_MAP_SWIZZLE_128B).
__device__ __forceinline__ int swz(int r, int cbytes) {
  return r * CHUNK_ROW + ((((cbytes >> 4) ^ r) & 7) << 4) + (cbytes & 15);
}

// K1's row statistics from a chunk in the ring: row tid / 2, the half tid % 2
// of its 128 bytes (four 16-byte runs), into rs (sum of x) and ss (sum of x *
// x, the square rounded to T first with `round_sq`), in f32.  Columns past K
// and rows past M are zero in the chunk.
template <typename T>
__device__ __forceinline__ void chunk_row_stats(const unsigned char* st, int tid, bool round_sq,
                                                float& rs, float& ss) {
  const int r = tid >> 1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 u = *reinterpret_cast<const uint4*>(st + swz(r, ((tid & 1) * 4 + q) * 16));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        const float v = __uint_as_float(w[i]);
        rs += v;
        ss += v * v;
      } else {
        const float v0 = __uint_as_float(w[i] << 16);
        const float v1 = __uint_as_float(w[i] & 0xffff0000u);
        float s0 = v0 * v0, s1 = v1 * v1;
        if (round_sq) {
          s0 = __bfloat162float(__float2bfloat16_rn(s0));
          s1 = __bfloat162float(__float2bfloat16_rn(s1));
        }
        rs += v0 + v1;
        ss += s0 + s1;
      }
    }
  }
}

// T: the operands' type.  TMA: x's rows and base are 16-byte aligned, and
// its chunks come by TMA; else element by element.  BN: columns of out a CTA
// (Tile).  CENTER: K1's epilogue --
// the row sums and sums of squares of x from the chunks in the ring, out =
// x w - (rs inv_t) colw rounded to its dtype, the row statistics (CTA column
// 0 only) as (m, 2) or as a CTA's f64 sums of rs^2 and ss.  STREAM (f32, TMA):
// w is split_w's chunks (kw = KC), each copied into its ring slot beside x's
// chunk, none held; else w is row-major, held whole or in panels of kw rows.
template <typename T, bool TMA, bool CENTER, int BN, bool STREAM = false>
__global__ void __launch_bounds__(THREADS, 1)
    matmul_tc(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ x,
              const T* __restrict__ w, void* __restrict__ out, int out_bf16, long long m, int k,
              int n, int kw, const CenterArgs ca) {
  using C = Cfg<T, BN>;
  static_assert(!STREAM || (sizeof(T) == 4 && TMA), "w streams for f32 x by TMA");
  constexpr int NACC = Tile<BN, STREAM>::NACC;
  constexpr int STAGES = Tile<BN, STREAM>::STAGES;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int STEPS = C::KC / C::KSTEP;  // MMA k-steps a chunk: 4
  constexpr int W_STAGE = STREAM ? C::KC * C::ROW_BYTES : 0;  // w's chunk a slot
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  unsigned char* planes = ring + STAGES * STAGE_BYTES;  // STREAM: w's slots
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(planes + (STREAM ? STAGES * W_STAGE : kw * C::ROW_BYTES));
  float* staged = reinterpret_cast<float*>(bars + STAGES);  // OUT_ROWS x BN sums
  float* mu = staged + OUT_ROWS * BN;                        // K1: the tile's row means

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's 16 rows of a tile
  const int n0 = blockIdx.y * BN;
  const long long row_tiles = (m + BM - 1) / BM;
  const int cpt = (k + C::KC - 1) / C::KC;  // chunks a tile
  const long long jobs = ((row_tiles - 1 - blockIdx.x) / gridDim.x + 1) * cpt;
  const bool paneled = k > kw;

  // chunk j of this CTA: tile j / cpt of its grid-stride walk, columns
  // (j % cpt) KC on
  auto issue = [&](long long j) {
    const long long it = j / cpt;
    const int c = (int)(j - it * cpt);
    const int s = (int)(j % STAGES);
    const uint32_t bar = smem_u32(bars + s);
    mbar_expect_tx(bar, STAGE_BYTES + W_STAGE);
    tma_load(smem_u32(ring + s * STAGE_BYTES), &xmap, c * C::KC,
             (int)((blockIdx.x + it * gridDim.x) * BM), bar);
    if constexpr (STREAM) {  // the chunk's rows of w's CTA column, split
      bulk_load(smem_u32(planes + s * W_STAGE),
                reinterpret_cast<const unsigned char*>(w) +
                    ((long long)blockIdx.y * cpt + c) * W_STAGE,
                W_STAGE, bar);
    }
  };
  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(bars + s));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < STAGES && s < jobs; ++s) issue(s);
    }
  }  // the barrier before the first stage_w (STREAM: the one below) orders the
     // inits before any wait
  if constexpr (STREAM) __syncthreads();

  // rows [kp0, kp0 + kwp) of w's CTA column into the planes, zero-padded
  auto stage_w = [&](int kp0, int kwp) {
    if constexpr (F32) {
      // element (kk, nn) in core matrix (nn / 8, kk / 4) of 8 n x 16 bytes
      // at word ((nn / 8) (kw / 4) + kk / 4) 32 + (nn % 8) 4 + kk % 4; a warp
      // reads 32 neighbouring n of four rows of w and writes whole
      // core-matrix rows
      uint32_t* hi = reinterpret_cast<uint32_t*>(planes);
      uint32_t* lo = hi + kw * BN;
      const int nkb = kw / 4;
#pragma unroll 8  // loads of eight items in flight: w comes from L2
      for (int q = tid; q < nkb * BN; q += THREADS) {
        const int nn = q % BN;
        const int kb = q / BN;
        const int gc = n0 + nn;
        uint32_t h[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = 4 * kb + i;
          const float v = (kk < kwp && gc < n) ? w[(long long)(kp0 + kk) * n + gc] : 0.f;
          atb_tc::split_tf32(v, h[i], l[i]);
        }
        const int word = ((nn >> 3) * nkb + kb) * 32 + (nn & 7) * 4;
        *reinterpret_cast<uint4*>(hi + word) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + word) = make_uint4(l[0], l[1], l[2], l[3]);
      }
    } else {
      // runs of 8 n of one k into core matrix (kk / 8, nn / 8) of 8 k x 16
      // bytes, at element ((kk / 8) (BN / 8) + nn / 8) 64 + (kk % 8) 8
      const unsigned short* wh = reinterpret_cast<const unsigned short*>(w);
      bf16* p = reinterpret_cast<bf16*>(planes);
      constexpr int NB = BN / 8;
#pragma unroll 2
      for (int q = tid; q < kw * NB; q += THREADS) {
        const int nb = q % NB;
        const int kk = q / NB;
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c0 = n0 + 8 * nb + 2 * e;
          const long long r = (long long)(kp0 + kk) * n;
          const uint32_t a = (kk < kwp && c0 < n) ? wh[r + c0] : 0u;
          const uint32_t b = (kk < kwp && c0 + 1 < n) ? wh[r + c0 + 1] : 0u;
          v[e] = a | (b << 16);
        }
        *reinterpret_cast<uint4*>(p + ((kk >> 3) * NB + nb) * 64 + (kk & 7) * 8) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  // chunk (row0, col0) of x into slot st element by element, zero-padded
  auto fill = [&](unsigned char* st, long long row0, int col0) {
    for (int e = tid; e < BM * C::KC; e += THREADS) {
      const int r = e / C::KC;
      const int c = e % C::KC;
      const long long gr = row0 + r;
      const bool ok = gr < m && col0 + c < k;
      if constexpr (F32) {
        *reinterpret_cast<float*>(st + swz(r, 4 * c)) = ok ? x[gr * k + col0 + c] : 0.f;
      } else {
        const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
        *reinterpret_cast<unsigned short*>(st + swz(r, 2 * c)) = ok ? xh[gr * k + col0 + c] : 0;
      }
    }
  };

  float acc[NACC], d[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = d[i] = 0.f;
  float rsum = 0.f, ssum = 0.f;     // K1: this thread's half of row tid / 2 of the tile
  double st_rs2 = 0.0, st_ss = 0.0;  // K1: its rows' rs^2 and ss, scalar statistics
  const uint32_t plane_hi = smem_u32(planes);  // held w
  int ci = 0;        // chunk of the current tile
  long long it = 0;  // tiles done
  for (long long j = 0; j < jobs; ++j) {
    const int col0 = ci * C::KC;
    const long long row0 = (blockIdx.x + it * gridDim.x) * BM;
    const int kp0 = paneled ? col0 / kw * kw : 0;
    if (!STREAM && (j == 0 || (paneled && col0 == kp0))) {
      __syncthreads();  // every MMA on the old panel has completed
      stage_w(kp0, min(kw, k - kp0));
      atb_tc::fence_proxy_async();  // the planes, to wgmma's reads
      __syncthreads();
    }
    const int s = (int)(j % STAGES);
    unsigned char* st = ring + s * STAGE_BYTES;
    if constexpr (TMA) {
      mbar_wait(smem_u32(bars + s), (uint32_t)((j / STAGES) & 1));
    } else {
      fill(st, row0, col0);
      __syncthreads();
    }
    const int steps = min(STEPS, (k - col0 + C::KSTEP - 1) / C::KSTEP);
    const int kk0 = (col0 - kp0) / C::KSTEP;  // the chunk's first k-step in the planes (STREAM: 0)
    if constexpr (F32) {
      const uint32_t w_hi = STREAM ? smem_u32(planes + s * W_STAGE) : plane_hi;
      const uint32_t w_lo = w_hi + kw * BN * 4;
      // A fragment of k8 step q: (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      uint32_t ah[STEPS][4], al[STEPS][4];
      const float* a = reinterpret_cast<const float*>(st);
#pragma unroll
      for (int q = 0; q < STEPS; ++q) {
        if (q < steps) {
          const int r = wrow + g;
          const int c = 4 * (8 * q + t);
          atb_tc::split_tf32(a[swz(r, c) / 4], ah[q][0], al[q][0]);
          atb_tc::split_tf32(a[swz(r + 8, c) / 4], ah[q][1], al[q][1]);
          atb_tc::split_tf32(a[swz(r, c + 16) / 4], ah[q][2], al[q][2]);
          atb_tc::split_tf32(a[swz(r + 8, c + 16) / 4], ah[q][3], al[q][3]);
        }
      }
      // K-major planes: the next core matrix along K 128 bytes on, the next
      // 8 n kw / 4 of them; a k8 step is two along K
      const uint32_t sbo = kw / 4 * 128;
      hold(d);
      atb_tc::wgmma_fence();
      // the small terms first, then the large ones
#pragma unroll
      for (int q = 0; q < STEPS; ++q) {
        if (q < steps) {
          const uint32_t off = (kk0 + q) * 256;
          wgmma_tf32(d, al[q], smem_desc(w_hi + off, 128, sbo), q == 0 ? 0 : 1);
          wgmma_tf32(d, ah[q], smem_desc(w_lo + off, 128, sbo), 1);
        }
      }
#pragma unroll
      for (int q = 0; q < STEPS; ++q) {
        if (q < steps) {
          wgmma_tf32(d, ah[q], smem_desc(w_hi + (kk0 + q) * 256, 128, sbo), 1);
        }
      }
      atb_tc::wgmma_commit();
      if constexpr (CENTER) chunk_row_stats<T>(st, tid, ca.square_in_storage, rsum, ssum);
      if constexpr (STREAM) atb_tc::wgmma_wait<0>();  // the MMAs read w's chunk in slot s
      __syncthreads();  // every warp's fragments of slot s are in registers
      if constexpr (TMA) {
        if (tid == 0 && j + STAGES < jobs) issue(j + STAGES);
      }
      atb_tc::wgmma_wait<0>();
      hold(d);
      hold(ah);
      hold(al);
    } else {
      // ldmatrix: lane l addresses row l % 8 of matrix l / 8, matrices
      // (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
      uint32_t af[STEPS][4];
      const int r = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
      const uint32_t base = smem_u32(st);
#pragma unroll
      for (int q = 0; q < STEPS; ++q) {
        if (q < steps) ldsm_x4(base + swz(r, 2 * (16 * q + 8 * (lane >> 4))), af[q]);
      }
      // MN-major core matrices of 8 k x 16 bytes: the next along K
      // (BN / 8) 128 bytes on, the next along N 128; a k16 step is two
      constexpr uint32_t KSTRIDE = BN / 8 * 128;
      if constexpr (CENTER) {
        // K1 rounds Y to bf16 after centring: every k16 step starts from
        // zero and its sum goes into acc rounded to nearest, so Y keeps the
        // accuracy of an f32 sum (PERF.md), where a sum chained over a
        // chunk is truncated by the tensor core
#pragma unroll
        for (int q = 0; q < STEPS; ++q) {
          if (q < steps) {
            hold(d);
            atb_tc::wgmma_fence();
            wgmma_bf16(d, af[q], smem_desc(plane_hi + (kk0 + q) * 2 * KSTRIDE, KSTRIDE, 128), 0);
            atb_tc::wgmma_commit();
            if (q == 0) {
              chunk_row_stats<T>(st, tid, ca.square_in_storage, rsum, ssum);
              __syncthreads();
              if constexpr (TMA) {
                if (tid == 0 && j + STAGES < jobs) issue(j + STAGES);
              }
            }
            atb_tc::wgmma_wait<0>();
            hold(d);
#pragma unroll
            for (int i = 0; i < NACC; ++i) acc[i] += d[i];
          }
        }
        hold(af);
      } else {
        hold(d);
        atb_tc::wgmma_fence();
#pragma unroll
        for (int q = 0; q < STEPS; ++q) {
          if (q < steps) {
            wgmma_bf16(d, af[q], smem_desc(plane_hi + (kk0 + q) * 2 * KSTRIDE, KSTRIDE, 128),
                       q == 0 ? 0 : 1);
          }
        }
        atb_tc::wgmma_commit();
        __syncthreads();
        if constexpr (TMA) {
          if (tid == 0 && j + STAGES < jobs) issue(j + STAGES);
        }
        atb_tc::wgmma_wait<0>();
        hold(d);
        hold(af);
      }
    }
    // the chunk's MMAs started from zero: their sum into acc, rounded to nearest
    if constexpr (F32 || !CENTER) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += d[i];
    }
    if (++ci == cpt) {  // the tile's last chunk: store it
      // Through shared memory, OUT_ROWS rows at a time (the rows of warps
      // 2 h and 2 h + 1), so that a warp's stores are 128 contiguous bytes
      // of out, not 32 bytes of each of 8 rows: accumulator 4 jn + q is row
      // g (+8 for q >= 2), column 8 jn + 2 t + (q & 1) of the warp's 16.
      const int rows = (int)min((long long)BM, m - row0);
      const int cols = min(BN, n - n0);
      if constexpr (CENTER) {  // the row's two halves; read after the barrier below
        rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
        ssum += __shfl_xor_sync(0xffffffffu, ssum, 1);
        const int r = tid >> 1;
        if ((tid & 1) == 0) {
          mu[r] = rsum * ca.inv_t;
          if (blockIdx.y == 0 && r < rows) {
            if (ca.stats != nullptr) {
              *reinterpret_cast<float2*>(ca.stats + (row0 + r) * 2) = make_float2(rsum, ssum);
            } else {
              st_rs2 += (double)rsum * rsum;
              st_ss += ssum;
            }
          }
        }
        rsum = ssum = 0.f;
      }
      for (int h = 0; h * OUT_ROWS < rows; ++h) {
        if ((warp >> 1) == h) {
#pragma unroll
          for (int i = 0; i < NACC; i += 2) {
            const int r = (warp & 1) * 16 + g + ((i & 3) >> 1) * 8;
            *reinterpret_cast<float2*>(staged + r * BN + (i >> 2) * 8 + 2 * t) =
                make_float2(acc[i], acc[i + 1]);
          }
        }
        __syncthreads();
        // a warp a row: 128 contiguous bytes of out a store
        const long long base = (row0 + h * OUT_ROWS) * n + n0;  // out's element (row, n0)
        const int nr = min(OUT_ROWS, rows - h * OUT_ROWS);
        for (int r = warp; r < nr; r += THREADS / 32) {
          for (int c = lane; c < cols; c += 32) {
            float val = staged[r * BN + c];
            if constexpr (CENTER) val -= __fmul_rn(mu[h * OUT_ROWS + r], __ldg(ca.colw + n0 + c));
            const long long o = base + (long long)r * n + c;
            if (out_bf16) {
              static_cast<bf16*>(out)[o] = __float2bfloat16_rn(val);
            } else {
              static_cast<float*>(out)[o] = val;
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
      ci = 0;
      ++it;
    }
  }
  if constexpr (CENTER) {  // a CTA's scalar statistics, summed in a fixed order
    if (ca.st_part != nullptr && blockIdx.y == 0) {
      double* red = reinterpret_cast<double*>(staged);  // 2 x THREADS, free after the stores
      __syncthreads();
      red[tid] = st_rs2;
      red[THREADS + tid] = st_ss;
      __syncthreads();
      for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (tid < s) {
          red[tid] += red[tid + s];
          red[THREADS + tid] += red[THREADS + tid + s];
        }
        __syncthreads();
      }
      if (tid == 0) {
        ca.st_part[blockIdx.x * 2] = red[0];
        ca.st_part[blockIdx.x * 2 + 1] = red[THREADS];
      }
    }
  }
}

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Let the instantiation take the most dynamic shared memory any K asks of
// it (w's planes at their deepest), once on each device: not at every
// launch, where the call is host time beside a ~0.04 ms kernel.  Static, so
// that each library that includes this header keeps its own flag: a flag
// of external linkage is one object in the whole process (a unique
// symbol), and a second build of a source loaded beside the first would
// find it set and leave its own kernel at the default limit.
template <typename T, bool TMA, bool CENTER, int BN, bool STREAM = false>
static cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ULL << dev;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(matmul_tc<T, TMA, CENTER, BN, STREAM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             STREAM ? smem_bytes<T, BN, true>(Cfg<T, BN>::KC)
                                    : smem_bytes<T, BN>(kmax<T, BN>()));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The grid of a launch on at most `ctas` CTAs, bn columns of out a CTA:
// (CTAs a column, columns).
inline dim3 grid_of(long long m, int n, int ctas, int bn) {
  const long long row_tiles = (m + BM - 1) / BM;
  const int col_tiles = (n + bn - 1) / bn;
  const long long per_col = ctas / col_tiles > 1 ? ctas / col_tiles : 1;
  return dim3((unsigned)(row_tiles < per_col ? row_tiles : per_col), (unsigned)col_tiles);
}

// With STREAM, w is split_w's chunks.
template <typename T, bool TMA, bool CENTER, int BN, bool STREAM = false>
cudaError_t launch(const void* x, const void* w, void* out, long long m, int k, int n, int out_bf16,
                   int ctas, const CenterArgs& ca, cudaStream_t stream) {
  CUtensorMap map{};
  if constexpr (TMA) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
    const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(T)};
    const cuuint32_t box[2] = {(cuuint32_t)Cfg<T, BN>::KC, (cuuint32_t)BM};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(
        &map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
        const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem<T, TMA, CENTER, BN, STREAM>();
  if (err != cudaSuccess) return err;
  if ((n + BN - 1) / BN > 65535) return cudaErrorInvalidValue;
  const int kw = STREAM ? Cfg<T, BN>::KC : panel_rows<T, BN>(k);
  matmul_tc<T, TMA, CENTER, BN, STREAM>
      <<<grid_of(m, n, ctas, BN), THREADS, smem_bytes<T, BN, STREAM>(kw), stream>>>(
          map, static_cast<const T*>(x), static_cast<const T*>(w), out, out_bf16, m, k, n, kw, ca);
  return cudaGetLastError();
}

// w (k x n, f32, row-major) into the chunks the streamed kernel copies
// (w_stream_bytes): for CTA column ct and chunk c of KC rows of K, at chunk
// ct cpt + c, the tf32 hi plane and then the lo plane, each in stage_w's
// K-major core-matrix layout at kw = KC and split as stage_w splits (so the
// streamed product is the held one, bit for bit); zero past k and n.  One
// thread a (chunk, 4 rows of K, column).
template <int BN>
__global__ void __launch_bounds__(256) split_w(const float* __restrict__ w,
                                               uint32_t* __restrict__ out, int k, int n, int cpt) {
  constexpr int KC = Cfg<float, BN>::KC;
  constexpr int NKB = KC / 4;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)((n + BN - 1) / BN) * cpt * NKB * BN;
  if (q >= total) return;
  const int nn = (int)(q % BN);
  const int kb = (int)(q / BN % NKB);
  const long long chunk = q / BN / NKB;  // ct cpt + c
  const int gc = (int)(chunk / cpt) * BN + nn;
  const int k0 = (int)(chunk % cpt) * KC + 4 * kb;
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = (k0 + i < k && gc < n) ? w[(long long)(k0 + i) * n + gc] : 0.f;
    atb_tc::split_tf32(v, h[i], l[i]);
  }
  uint32_t* hi = out + chunk * 2 * KC * BN;
  const int word = ((nn >> 3) * NKB + kb) * 32 + (nn & 7) * 4;
  *reinterpret_cast<uint4*>(hi + word) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(hi + KC * BN + word) = make_uint4(l[0], l[1], l[2], l[3]);
}

// x's base and row stride allow its chunks by TMA.
template <typename T>
bool tma_ok(const void* x, int k) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && (k * sizeof(T)) % 16 == 0;
}

// out (m x n, f32 or bf16) = x (m x k, f32, TMA-aligned) @ w (k x n, f32) with
// w streamed: split_w into w_split (w_stream_bytes<BN>(k, n) bytes), then the
// streamed kernel, on `stream`.
template <bool CENTER, int BN>
cudaError_t dispatch_streamed(const void* x, const void* w, void* w_split, void* out, long long m,
                              int k, int n, int out_bf16, int ctas, const CenterArgs& ca,
                              cudaStream_t s) {
  if (m < 1 || k < 1 || n < 1 || ctas < 1 || m > 0x7fffffffLL || w_split == nullptr ||
      !tma_ok<float>(x, k)) {
    return cudaErrorInvalidValue;
  }
  constexpr int KC = Cfg<float, BN>::KC;
  const int cpt = (k + KC - 1) / KC;
  const long long threads = (long long)((n + BN - 1) / BN) * cpt * (KC / 4) * BN;
  split_w<BN><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(w), static_cast<uint32_t*>(w_split), k, n, cpt);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch<float, true, CENTER, BN, true>(x, w_split, out, m, k, n, out_bf16, ctas, ca, s);
}

// out (m x n, f32 or bf16) = x (m x k) @ w (k x n) of type T, both row-major,
// BN columns of out a CTA, with K1's epilogue where CENTER, on at most `ctas`
// CTAs; by TMA where x's base and row stride are 16-byte aligned.
template <typename T, bool CENTER, int BN>
cudaError_t dispatch(const void* x, const void* w, void* out, long long m, int k, int n,
                     int out_bf16, int ctas, const CenterArgs& ca, cudaStream_t s) {
  if (m < 1 || k < 1 || n < 1 || ctas < 1 || m > 0x7fffffffLL) return cudaErrorInvalidValue;
  return tma_ok<T>(x, k) ? launch<T, true, CENTER, BN>(x, w, out, m, k, n, out_bf16, ctas, ca, s)
             : launch<T, false, CENTER, BN>(x, w, out, m, k, n, out_bf16, ctas, ca, s);
}

// CTAs of the kernel that fit one SM at once at depth k, into *out.
template <typename T, bool CENTER, int BN, bool STREAM = false>
cudaError_t ctas_per_sm(int k, int* out) {
  const cudaError_t err = allow_smem<T, true, CENTER, BN, STREAM>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, matmul_tc<T, true, CENTER, BN, STREAM>, THREADS,
      STREAM ? smem_bytes<T, BN, true>(Cfg<T, BN>::KC) : smem_bytes<T, BN>(panel_rows<T, BN>(k)));
}

}  // namespace mm_tc
