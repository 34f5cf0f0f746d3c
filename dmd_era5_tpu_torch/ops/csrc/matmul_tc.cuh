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
//   occupancy query), in columns of BN output columns, BN a wgmma width of
//   the tile table below.  ops/matmul.py::matmul_block chooses BN, the copy
//   path, w's rows held and the ring's depth from the shape; the launchers
//   pass them in and `launch` checks them.  A CTA loads its column of w
//   once, splits it into K-major tf32 hi and lo planes (transposed on the
//   way in, as K3's B) or, for bf16, stores it MN-major for wgmma's
//   transpose bit (as K3-bf16's B), and then walks 128-row tiles of x,
//   grid-stride, until the rows run out.
// - x is the A operand: its rows are K-contiguous, as tf32 wgmma wants.  It
//   streams through a ring of `stages` slots, as many as the shared memory
//   beside w holds up to 4 (the kernel takes up to MAX_STAGES), on one of
//   three copy paths:
//     TMA   rows and base 16-byte aligned (K % 4 == 0 in f32, K % 8 in
//           bf16): chunks of 128 rows x 128 bytes (32 f32 or 64 bf16
//           columns of K), each one TMA copy with the 128-byte swizzle,
//           out-of-range rows and columns filled with zeros by the copy
//           engine;
//     BULK  f32 rows that are not (K 97) on an aligned base: a tile's 128
//           rows are one contiguous span of 512 K bytes, 16-byte aligned,
//           so one bulk copy (cp.async.bulk, no tensor map) brings the whole
//           tile into its slot, dense (row r at word r K), and ordinary
//           loads the last tile's final partial 16 bytes.  Each whole
//           32-column group is read in the order of dense_col, and w's
//           planes are staged in it, so that a warp's fragment loads from
//           rows K words apart meet no bank twice (a partial last group in
//           K's order: its fewest k-steps);
//     ELEM  the rest (a base not 16-byte aligned, bf16 rows not aligned, f32
//           ones where two tile slots do not fit, or at 112 and 128
//           columns): the TMA path's swizzled chunks filled by ordinary
//           loads and a CTA barrier.  On the smoke's main paths only 19c-d's
//           small DMDc blocks take it (34 x 166 and 6 x 95 rows).
//   One thread keeps the ring full; a slot is refilled as soon as every warp
//   has its A fragments of it in registers, while that chunk's MMAs run.
// - Two consumer warpgroups own rows 0-63 and 64-127 of a tile.  f32: each
//   warp reads its 16 rows' fragments from the slot, splits them in
//   registers, and issues per chunk the small terms A_lo B_hi + A_hi B_lo of
//   its four k8 steps, then A_hi B_hi (m64nBNk8); bf16: ldmatrix fragments,
//   four m64nBNk16 MMAs.
// - Accumulation: the tensor core rounds its sums toward zero, so the MMAs
//   of each chunk (4 k-steps; every k-step in K1's bf16 sketch) start from
//   zero and their sum is added into f32 accumulators rounded to nearest
//   (chained over a tile instead, out read 2.2-3.8x the plain f32 product's
//   error against the f64 product: the `chained` variant of
//   scripts/torch_k6_phases.py, PERF.md).
// - Epilogue: a tile's sums go through shared memory (the whole tile where
//   BN <= 80, else 32 rows at a time), and each warp stores whole rows of
//   out, as 16-byte runs where out's rows allow them, else element by
//   element (f32 or bf16, masked on ragged M and N), while the ring already
//   holds the next tile's first chunks.
//
// What the card showed (PERF.md, PR 24): the phases of a CTA still run one
// after another -- copies, MMAs, stores -- and in this design none holds
// more than 45% of a call.  Before it the element-wise copies of rows that are not
// 16-byte aligned took 54-60% (16e, config 2's sketch), the 112-wide MMAs at
// N 24 and the element stores 68% of 15c; now no copy saves 18-30% there and
// no MMA 27-44%.  K1's bf16 sketch loses to one library call (2.0x at the
// bench's shape) with no phase above 15%: two MMAs in flight and slots
// released by per-slot barriers both read slower.
//
// Tile table (each choice and what decided it on an H100, NVIDIA H100 80GB
// HBM3 at 700 W, scripts/torch_k6_phases.py and scripts/torch_k6_times.py;
// PERF.md has the numbers.  It stands in for the TPU tile sweep of the
// nearest product, scripts/kernel_tune.py:218-225):
//
//   rows a tile       128   two m64 warpgroups
//   columns a CTA     24, 40, 80, 112, 128: the narrowest that holds N (15c's
//                     and 16d's N 24 and 20 -> 24, 16e's 40 -> 40, K1's 76 at
//                     config 2 -> 80, the streamed block's 110 -> 112, 15a's
//                     128 -> 128); wider N in columns of 112 (K6) or 128
//                     (K1's sketch: 128 read 12% under 112 at N 224, PR 9).
//                     At N 24 a 112-wide column did 4.7x the useful MMAs.
//   chunk of K        128 B the 128-byte swizzle's row; 4 MMA k-steps
//   ring              2-4   what the shared memory beside w holds, at most 4:
//                           8 read within 3% at 15c, the lift chunk and K1's
//                           bf16 sketch, 5% slower at the bf16 block (ring_8)
//   MMA chain         4     k-steps between restarts from zero (one chunk);
//                           K1's bf16 sketch: 1, one MMA at a time (two in
//                           flight in halves or n32 quarters read 5-30%
//                           slower at the bench's shape, the fit step, d = 3)
//   rows staged       128 where BN <= 80, else 32 (the room beside w)
//   threads           256   two consumer warpgroups, no producer warp: one
//                           thread issues the copies between its MMAs
//
// Shared-memory budget (227 KB a CTA; ops/matmul.py::_mm_smem is the same
// sum): w takes K x BN x 8 bytes for f32 (hi and lo planes: 150.5 KB at K
// 168, BN 112) and K x BN x 2 for bf16, K padded to the MMA's depth (BULK:
// to 32) in shared memory only; the staged rows of out 128 or 32 x BN x 4,
// K1's row means 0.5 KB, the barriers 64 bytes; the ring the rest, 16 KB a
// chunk slot (BULK: 512 K bytes a tile slot), at least 2 slots.  Where w's
// rows do not fit beside two slots they are walked in panels of 160 (f32)
// or 640 (bf16) rows of K, restaged once a tile and panel (from L2: w is
// small).  N > BN takes more CTA columns.
//
// Streamed w (STREAM; K1's and K2's sketch past 176 rows of K, f32 x by
// TMA, BN 128): a panel's restage is two CTA-wide barriers and a tf32
// split of as many elements of w as the tile streams of x, and took 40% of
// the sketch at the hourly year (T 8,760).  So split_w splits w once a call
// into device memory (18 MB at the year's N 256, held in L2), as the chunks
// the kernel reads -- per CTA column and KC rows of K, the hi plane then
// the lo plane, each in stage_w's layout at kw = KC -- and each chunk of w
// rides the ring beside its chunk of x: one bulk copy of 32 KB on the same
// barrier as x's 16 KB, four slots (192 KB).  No barrier, split or restage
// stands between the MMAs; a slot is refilled once the MMAs that read its w
// have completed.  The product is the held one bit for bit (the same
// splits, the same MMA order).
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

// ------------------------------------------- warpgroup MMAs at width 8 C
//
// TC_WGMMA(C, N) defines wgmma_tf32 and wgmma_bf16 at n = N = 8 C in the
// namespace where it is expanded: d (+)= a b, 64 x N, a a warp's 16 rows in
// registers (the m16n8k8 tf32 or m16n8k16 bf16 fragment), b from a
// descriptor (bf16: MN-major, through the transpose bit); d as C n8 tiles
// of the m16n8 accumulator layout; scale_d 0 ignores d's old value.  This
// kernel's widths below, K3's in project_wgmma.cuh.

#define TC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TC_OPS1 TC_D4(0)
#define TC_OPS2 TC_OPS1, TC_D4(4)
#define TC_OPS3 TC_OPS2, TC_D4(8)
#define TC_OPS4 TC_OPS3, TC_D4(12)
#define TC_OPS5 TC_OPS4, TC_D4(16)
#define TC_OPS6 TC_OPS5, TC_D4(20)
#define TC_OPS7 TC_OPS6, TC_D4(24)
#define TC_OPS8 TC_OPS7, TC_D4(28)
#define TC_OPS9 TC_OPS8, TC_D4(32)
#define TC_OPS10 TC_OPS9, TC_D4(36)
#define TC_OPS11 TC_OPS10, TC_D4(40)
#define TC_OPS12 TC_OPS11, TC_D4(44)
#define TC_OPS13 TC_OPS12, TC_D4(48)
#define TC_OPS14 TC_OPS13, TC_D4(52)
#define TC_OPS15 TC_OPS14, TC_D4(56)
#define TC_OPS16 TC_OPS15, TC_D4(60)
#define TC_REG1 "%0, %1, %2, %3"
#define TC_REG2 TC_REG1 ", %4, %5, %6, %7"
#define TC_REG3 TC_REG2 ", %8, %9, %10, %11"
#define TC_REG4 TC_REG3 ", %12, %13, %14, %15"
#define TC_REG5 TC_REG4 ", %16, %17, %18, %19"
#define TC_REG6 TC_REG5 ", %20, %21, %22, %23"
#define TC_REG7 TC_REG6 ", %24, %25, %26, %27"
#define TC_REG8 TC_REG7 ", %28, %29, %30, %31"
#define TC_REG9 TC_REG8 ", %32, %33, %34, %35"
#define TC_REG10 TC_REG9 ", %36, %37, %38, %39"
#define TC_REG11 TC_REG10 ", %40, %41, %42, %43"
#define TC_REG12 TC_REG11 ", %44, %45, %46, %47"
#define TC_REG13 TC_REG12 ", %48, %49, %50, %51"
#define TC_REG14 TC_REG13 ", %52, %53, %54, %55"
#define TC_REG15 TC_REG14 ", %56, %57, %58, %59"
#define TC_REG16 TC_REG15 ", %60, %61, %62, %63"
#define TC_IN1 "{%4, %5, %6, %7}, %8"
#define TC_SC1 "%9"
#define TC_IN2 "{%8, %9, %10, %11}, %12"
#define TC_SC2 "%13"
#define TC_IN3 "{%12, %13, %14, %15}, %16"
#define TC_SC3 "%17"
#define TC_IN4 "{%16, %17, %18, %19}, %20"
#define TC_SC4 "%21"
#define TC_IN5 "{%20, %21, %22, %23}, %24"
#define TC_SC5 "%25"
#define TC_IN6 "{%24, %25, %26, %27}, %28"
#define TC_SC6 "%29"
#define TC_IN7 "{%28, %29, %30, %31}, %32"
#define TC_SC7 "%33"
#define TC_IN8 "{%32, %33, %34, %35}, %36"
#define TC_SC8 "%37"
#define TC_IN9 "{%36, %37, %38, %39}, %40"
#define TC_SC9 "%41"
#define TC_IN10 "{%40, %41, %42, %43}, %44"
#define TC_SC10 "%45"
#define TC_IN11 "{%44, %45, %46, %47}, %48"
#define TC_SC11 "%49"
#define TC_IN12 "{%48, %49, %50, %51}, %52"
#define TC_SC12 "%53"
#define TC_IN13 "{%52, %53, %54, %55}, %56"
#define TC_SC13 "%57"
#define TC_IN14 "{%56, %57, %58, %59}, %60"
#define TC_SC14 "%61"
#define TC_IN15 "{%60, %61, %62, %63}, %64"
#define TC_SC15 "%65"
#define TC_IN16 "{%64, %65, %66, %67}, %68"
#define TC_SC16 "%69"

#define TC_WGMMA(C, N)                                                                       \
  __device__ __forceinline__ void wgmma_tf32(float(&d)[4 * C], const uint32_t(&a)[4],       \
                                             uint64_t desc, int scale_d) {                   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " TC_SC##C ", 0;\n"                       \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" TC_REG##C "}, "  \
                 TC_IN##C ", p, 1, 1;\n}\n"                                                   \
                 : TC_OPS##C                                                                 \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));    \
  }                                                                                          \
  __device__ __forceinline__ void wgmma_bf16(float(&d)[4 * C], const uint32_t(&a)[4],       \
                                             uint64_t desc, int scale_d) {                   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " TC_SC##C ", 0;\n"                       \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" TC_REG##C "}, " \
                 TC_IN##C ", p, 1, 1, 1;\n}\n"                                                \
                 : TC_OPS##C                                                                 \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));    \
  }

namespace mm_tc {

using atb_tc::bf16;
using atb_tc::smem_u32;

TC_WGMMA(3, 24)
TC_WGMMA(5, 40)
TC_WGMMA(10, 80)
TC_WGMMA(14, 112)
TC_WGMMA(16, 128)

constexpr int THREADS = 256;
constexpr int BM = 128;                      // rows of x a tile
constexpr int CHUNK_ROW = 128;               // bytes of a chunk's row: the swizzle's
constexpr int STAGE_BYTES = BM * CHUNK_ROW;  // 16 KB: a chunk slot (TMA, ELEM)
constexpr int SMEM_CAP = 232448;             // shared memory of one CTA
constexpr int ALIGN = 1024;                  // the 128-byte swizzle's period
constexpr int MAX_STAGES = 8;                // ring slots, at most
constexpr int BAR_BYTES = MAX_STAGES * 8;
constexpr int MU_BYTES = BM * 4;             // the tile's row means (K1's epilogue)

// x's copy path (the note above); ops/matmul.py passes its number.
enum Load : int { TMA = 0, BULK = 1, ELEM = 2 };

__host__ __device__ constexpr bool is_width(int bn) {
  return bn == 24 || bn == 40 || bn == 80 || bn == 112 || bn == 128;
}
// Rows of a tile staged at once for the stores.
__host__ __device__ constexpr int out_rows(int bn) { return bn <= 80 ? BM : 32; }

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int KC = CHUNK_ROW / 4;  // columns of K a chunk
  static constexpr int KSTEP = 8;           // K of one MMA
  static constexpr int W_BYTES = 8;         // w's bytes a row of K and column: hi and lo planes
};
template <>
struct Cfg<bf16> {
  static constexpr int KC = CHUNK_ROW / 2;
  static constexpr int KSTEP = 16;
  static constexpr int W_BYTES = 2;
};

// Bytes of a ring slot: a chunk of x, or (BULK) a tile of f32 rows of depth
// k, rounded up to 128.
inline long long slot_bytes(int load, int k) {
  return load == BULK ? ((long long)BM * k * 4 + 127) / 128 * 128 : STAGE_BYTES;
}

// Shared memory of a CTA: the ring, w (kw rows of K held, or with STREAM a
// chunk of KC rows in each slot), the barriers, the staged rows of out and
// K1's row means.
template <typename T, int BN, bool STREAM = false>
long long smem_bytes(int load, int k, int kw, int stages) {
  const long long w_area = STREAM ? (long long)stages * Cfg<T>::KC * Cfg<T>::W_BYTES * BN
                                  : (long long)kw * Cfg<T>::W_BYTES * BN;
  return ALIGN + stages * slot_bytes(load, k) + w_area + BAR_BYTES + out_rows(BN) * BN * 4 +
         MU_BYTES;
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

// BULK: the column of its 32-column group (0-31) that virtual column kk of
// the group holds, k-step kk / 8 and A column kk % 8; gap: 1 where k is
// odd, 2 where k = 2 mod 4, 8 where k = 4 mod 8 (the first column of k-step
// q is gap q).  A warp's fragment load reads A column t (or t + 4) of rows g
// = 0-7 at word g k + col: with k odd, the columns 8 t (+ q, + 4) put the
// four t in four different sets of 8 banks and g k covers the 8 of each
// set; with k = 2 mod 4, g k covers 8 of the 16 even banks and g k + 16 the
// other 8, so the columns t % 2 + 16 (t / 2) (+ 2 q, + 8) do; with k = 4 mod
// 8, g k covers the 8 multiples of 4 and t the rest, in order.  Each order
// is a permutation of the group, and w's planes are staged in it.
__device__ __forceinline__ int dense_col(int kk, int gap) {
  const int q = kk >> 3, t = kk & 3, hi = (kk >> 2) & 1;
  return gap == 1   ? 8 * t + q + 4 * hi
         : gap == 2 ? (t & 1) + 16 * (t >> 1) + 2 * q + 8 * hi
                    : kk;
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

// The same from a BULK tile (f32, row r at word r k): row tid / 2, the 16
// columns from col0 + 16 (tid % 2) that lie below k, in order.  Rows past M
// hold stale words: their sums are never stored.
__device__ __forceinline__ void dense_row_stats(const float* tile, int k, int col0, int tid,
                                                float& rs, float& ss) {
  const float* row = tile + (tid >> 1) * k;
  const int c0 = col0 + (tid & 1) * 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float v = c0 + i < k ? row[c0 + i] : 0.f;
    rs += v;
    ss += v * v;
  }
}

// T: the operands' type.  LOAD: x's copy path (Load).  BN: columns of out a
// CTA.  CENTER: K1's epilogue -- the row sums and sums of squares of x from
// the chunks in the ring, out = x w - (rs inv_t) colw rounded to its dtype,
// the row statistics (CTA column 0 only) as (m, 2) or as a CTA's f64 sums of
// rs^2 and ss.  STREAM (f32, TMA): w is split_w's chunks (kw = KC), each
// copied into its ring slot beside x's chunk, none held; else w is
// row-major, held whole or in panels of kw rows.  stages: the ring's slots;
// slot: the bytes of one (slot_bytes).
template <typename T, int LOAD, bool CENTER, int BN, bool STREAM = false>
__global__ void __launch_bounds__(THREADS, 1)
    matmul_tc(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ x,
              const T* __restrict__ w, void* __restrict__ out, int out_bf16, long long m, int k,
              int n, int kw, int stages, int slot, const CenterArgs ca) {
  using C = Cfg<T>;
  static_assert(is_width(BN), "a wgmma width of the table");
  static_assert(!STREAM || (sizeof(T) == 4 && LOAD == TMA), "w streams for f32 x by TMA");
  static_assert(LOAD != BULK || sizeof(T) == 4, "BULK tiles are f32 rows");
  constexpr int NACC = BN / 2;  // f32 accumulators a thread: m64 x nBN a warpgroup
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int STEPS = C::KC / C::KSTEP;  // MMA k-steps a chunk: 4
  constexpr int W_STAGE = STREAM ? C::KC * C::W_BYTES * BN : 0;  // w's chunk a slot
  constexpr int OUT_ROWS = out_rows(BN);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  unsigned char* planes = ring + (long long)stages * slot;  // STREAM: w's slots
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      planes + (STREAM ? stages * W_STAGE : kw * C::W_BYTES * BN));
  float* staged = reinterpret_cast<float*>(bars + MAX_STAGES);  // OUT_ROWS x BN sums
  float* mu = staged + OUT_ROWS * BN;                            // K1: the tile's row means

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's 16 rows of a tile
  const int n0 = blockIdx.y * BN;
  const long long row_tiles = (m + BM - 1) / BM;
  const int cpt = (k + C::KC - 1) / C::KC;  // chunks a tile
  const long long tiles = (row_tiles - 1 - blockIdx.x) / gridDim.x + 1;  // this CTA's
  const long long jobs = tiles * cpt;
  const long long ring_jobs = LOAD == BULK ? tiles : jobs;  // the ring's uses: tiles or chunks
  const bool paneled = k > kw;
  const int gap = k & 1 ? 1 : (k & 3) == 2 ? 2 : 8;  // BULK's column order (dense_col)
  // BULK: the order of the 32-column group from col0 on: gap where it is
  // whole; in k's order where k cuts it, so that its k-steps are the fewest
  // that hold its columns (a permuted partial group spreads them over all
  // four, and each more step is one more of the tensor core's truncated
  // sums: at 4,096 x 22 @ 22 x 12, 2.2x the plain f32 product's error)
  auto order = [&](int col0) { return col0 + 32 <= k ? gap : 8; };
  // stores of 16 bytes: out's base, rows and this CTA's columns 16-byte aligned
  const int vec = out_bf16 ? 8 : 4;  // elements of out in 16 bytes
  const bool vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 && n % vec == 0 &&
                       min(BN, n - n0) % vec == 0;

  // use j of the ring, into slot j % stages: chunk j of this CTA's
  // grid-stride walk (tile j / cpt, columns (j % cpt) KC on), or with BULK
  // its tile j
  auto issue = [&](long long j) {
    const int s = (int)(j % stages);
    const uint32_t bar = smem_u32(bars + s);
    unsigned char* dst = ring + (long long)s * slot;
    if constexpr (LOAD == BULK) {
      const long long row0 = (blockIdx.x + j * gridDim.x) * BM;
      const long long bytes = min((long long)BM, m - row0) * k * 4;
      const long long whole = bytes & ~15LL;  // the bulk copy's: a multiple of 16
      const unsigned char* src = reinterpret_cast<const unsigned char*>(x) + row0 * k * 4;
      if (whole < bytes) {  // the span's last partial 16 bytes, by ordinary loads
        for (long long b = whole; b < bytes; b += 4) {
          *reinterpret_cast<float*>(dst + b) = *reinterpret_cast<const float*>(src + b);
        }
        atb_tc::fence_proxy_async();
      }
      mbar_expect_tx(bar, (uint32_t)whole);  // its arrive releases the stores above
      if (whole > 0) bulk_load(smem_u32(dst), src, (uint32_t)whole, bar);
    } else {
      const long long it = j / cpt;
      const int c = (int)(j - it * cpt);
      mbar_expect_tx(bar, STAGE_BYTES + W_STAGE);
      tma_load(smem_u32(dst), &xmap, c * C::KC, (int)((blockIdx.x + it * gridDim.x) * BM), bar);
      if constexpr (STREAM) {  // the chunk's rows of w's CTA column, split
        bulk_load(smem_u32(planes + s * W_STAGE),
                  reinterpret_cast<const unsigned char*>(w) +
                      ((long long)blockIdx.y * cpt + c) * W_STAGE,
                  W_STAGE, bar);
      }
    }
  };
  if constexpr (LOAD != ELEM) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(smem_u32(bars + s));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < stages && s < ring_jobs; ++s) issue(s);  // copy
    }
  }  // the barrier before the first stage_w (STREAM: the one below) orders the
     // inits before any wait
  if constexpr (STREAM) __syncthreads();

  // rows [kp0, kp0 + kwp) of w's CTA column into the planes, zero-padded
  // (BULK: each 32-row group in dense_col's order)
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
          const int kr = LOAD == BULK ? (kk & ~31) + dense_col(kk & 31, order(kk & ~31)) : kk;
          const float v = (kr < kwp && gc < n) ? w[(long long)(kp0 + kr) * n + gc] : 0.f;
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
  // K1's row statistics of the chunk at column col0 in slot st
  auto row_stats = [&](const unsigned char* st, int col0) {
    if constexpr (LOAD == BULK) {
      dense_row_stats(reinterpret_cast<const float*>(st), k, col0, tid, rsum, ssum);
    } else {
      chunk_row_stats<T>(st, tid, ca.square_in_storage, rsum, ssum);
    }
  };
  // the chunk at column col0's k-steps that hold columns below k
  auto steps_of = [&](int col0) {
    const int first = LOAD == BULK ? order(col0) : C::KSTEP;  // columns a k-step's first moves on
    return min(STEPS, (k - col0 + first - 1) / first);
  };
  // f32: the A fragments of the chunk at column col0 in slot st, split into
  // tf32 hi and lo; k8 step q: (row g, k t), (g + 8, t), (g, t + 4), (g + 8,
  // t + 4)
  auto frags = [&](const unsigned char* st, int col0, int steps, uint32_t (&ah)[STEPS][4],
                   uint32_t (&al)[STEPS][4]) {
    if constexpr (LOAD == BULK) {
      const float* r0p = reinterpret_cast<const float*>(st) + (wrow + g) * k;
      const float* r1p = r0p + 8 * k;
#pragma unroll
      for (int q = 0; q < STEPS; ++q) {
        if (q < steps) {
          const int c0 = col0 + dense_col(8 * q + t, order(col0));
          const int c1 = col0 + dense_col(8 * q + t + 4, order(col0));
          atb_tc::split_tf32(c0 < k ? r0p[c0] : 0.f, ah[q][0], al[q][0]);
          atb_tc::split_tf32(c0 < k ? r1p[c0] : 0.f, ah[q][1], al[q][1]);
          atb_tc::split_tf32(c1 < k ? r0p[c1] : 0.f, ah[q][2], al[q][2]);
          atb_tc::split_tf32(c1 < k ? r1p[c1] : 0.f, ah[q][3], al[q][3]);
        }
      }
    } else {
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
    }
  };
  const uint32_t plane_hi = smem_u32(planes);  // held w
  int ci = 0;        // chunk of the current tile
  long long it = 0;  // tiles done
  int s = 0;           // the ring's slot of this chunk
  uint32_t phase = 0;  // the parity of the slot's current use
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
    const long long ring_j = LOAD == BULK ? it : j;  // this chunk's use of the ring, in slot s
    const long long nxt = ring_j + stages;            // the use that refills slot s
    // the slot is refilled after this chunk (BULK: the tile's last chunk)
    const bool last_use = LOAD == TMA || (LOAD == BULK && ci == cpt - 1);
    unsigned char* st = ring + (long long)s * slot;
    if constexpr (LOAD == ELEM) {
      fill(st, row0, col0);  // copy
      __syncthreads();
    } else if (LOAD == TMA || ci == 0) {
      mbar_wait(smem_u32(bars + s), phase);  // copy
    }
    const int steps = steps_of(col0);
    const int kk0 = (col0 - kp0) / C::KSTEP;  // the chunk's first k-step in the planes (STREAM: 0)
    if constexpr (F32) {
      const uint32_t w_hi = STREAM ? smem_u32(planes + s * W_STAGE) : plane_hi;
      const uint32_t w_lo = w_hi + kw * BN * 4;
      uint32_t ah[STEPS][4], al[STEPS][4];
      frags(st, col0, steps, ah, al);
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
      if constexpr (CENTER) row_stats(st, col0);
      if constexpr (STREAM) atb_tc::wgmma_wait<0>();  // the MMAs read w's chunk in slot s
      if (LOAD != ELEM && last_use) {
        __syncthreads();  // every warp's fragments of slot s are in registers
        if (tid == 0 && nxt < ring_jobs) issue(nxt);  // copy
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
        // chunk is truncated by the tensor core.  One step at a time: two in
        // flight need a second set of outputs (64 registers at 128 columns:
        // ptxas spilled) or the step in column parts, which read 5-30%
        // slower (PERF.md §6, PR 24's design runs).
#pragma unroll
        for (int q = 0; q < STEPS; ++q) {
          if (q < steps) {
            hold(d);
            atb_tc::wgmma_fence();
            wgmma_bf16(d, af[q], smem_desc(plane_hi + (kk0 + q) * 2 * KSTRIDE, KSTRIDE, 128), 0);
            atb_tc::wgmma_commit();
            if (q == 0) {
              if constexpr (CENTER) row_stats(st, col0);
              if (LOAD != ELEM && last_use) {
                __syncthreads();  // every warp's fragments of slot s are in registers
                if (tid == 0 && nxt < ring_jobs) issue(nxt);  // copy
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
        if (LOAD != ELEM && last_use) {
          __syncthreads();  // every warp's fragments of slot s are in registers
          if (tid == 0 && nxt < ring_jobs) issue(nxt);  // copy
        }
        atb_tc::wgmma_wait<0>();
        hold(d);
        hold(af);
      }
    }
    // the chunk's MMAs started from zero: their sum into acc, rounded to nearest
    if constexpr (F32 || !CENTER) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += d[i];  // restart
    }
    if (LOAD != BULK || ci == cpt - 1) {  // the next chunk's (BULK: tile's) slot
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    if (++ci == cpt) {  // the tile's last chunk: store it
      // Through shared memory, OUT_ROWS rows at a time (written by the
      // warps whose 16 rows fall in them): accumulator 4 jn + q is row g
      // (+8 for q >= 2), column 8 jn + 2 t + (q & 1) of the warp's 16.
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
        if (wrow / OUT_ROWS == h) {
#pragma unroll
          for (int i = 0; i < NACC; i += 2) {
            const int r = wrow - h * OUT_ROWS + g + ((i & 3) >> 1) * 8;
            *reinterpret_cast<float2*>(staged + r * BN + (i >> 2) * 8 + 2 * t) =
                make_float2(acc[i], acc[i + 1]);
          }
        }
        __syncthreads();
        // 16-byte stores where out's rows allow them: a warp's lanes on
        // 32 / cv rows of cv 16-byte runs; else a warp a row, its lanes on
        // consecutive elements
        const long long base = (row0 + h * OUT_ROWS) * n + n0;  // out's element (row, n0)
        const int nr = min(OUT_ROWS, rows - h * OUT_ROWS);
        if (vec_out) {
          const int cv = cols / vec;  // 16-byte runs a row: at most 32
          const int rpi = 32 / cv;    // rows a warp stores at once
          const int r_off = lane / cv;
          const int c = (lane - r_off * cv) * vec;
          for (int r = warp * rpi + r_off; r_off < rpi && r < nr; r += THREADS / 32 * rpi) {
            const float* src = staged + r * BN + c;
            float v[8];
#pragma unroll
            for (int i = 0; i < 8; i += 4) {
              if (i < vec) {
                const float4 f = *reinterpret_cast<const float4*>(src + i);
                v[i] = f.x;
                v[i + 1] = f.y;
                v[i + 2] = f.z;
                v[i + 3] = f.w;
              }
            }
            if constexpr (CENTER) {
              const float m_r = mu[h * OUT_ROWS + r];
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                if (i < vec) v[i] -= __fmul_rn(m_r, __ldg(ca.colw + n0 + c + i));
              }
            }
            const long long o = base + (long long)r * n + c;
            if (out_bf16) {
              uint32_t p[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                p[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
                       ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
              }
              *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) = make_uint4(p[0], p[1], p[2], p[3]);
            } else {
              *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
                  make_float4(v[0], v[1], v[2], v[3]);
            }
          }
        } else {
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

// w (k x n, f32, row-major) into the chunks the streamed kernel copies: for
// CTA column ct and chunk c of KC rows of K, at chunk ct cpt + c, the tf32
// hi plane and then the lo plane (KC BN 8 bytes), each in stage_w's K-major
// core-matrix layout at kw = KC and split as stage_w splits (so the
// streamed product is the held one, bit for bit); zero past k and n.  One
// thread a (chunk, 4 rows of K, column).
template <int BN>
__global__ void __launch_bounds__(256) split_w(const float* __restrict__ w,
                                               uint32_t* __restrict__ out, int k, int n, int cpt) {
  constexpr int KC = Cfg<float>::KC;
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

// Let the instantiation take all the dynamic shared memory a CTA may have,
// once on each device: not at every launch, where the call is host time
// beside a ~0.04 ms kernel.  Static, so that each library that includes
// this header keeps its own flag: a flag of external linkage is one object
// in the whole process (a unique symbol), and a second build of a source
// loaded beside the first would find it set and leave its own kernel at
// the default limit.
template <typename T, int LOAD, bool CENTER, int BN, bool STREAM = false>
static cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ULL << dev;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(matmul_tc<T, LOAD, CENTER, BN, STREAM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
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

// x's base and row stride allow its chunks by TMA.
template <typename T>
bool tma_ok(const void* x, int k) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && (k * sizeof(T)) % 16 == 0;
}

// out (m x n, f32 or bf16) = x (m x k) @ w (k x n) of type T, both row-major
// (with STREAM, w is split_w's chunks), on at most `ctas` CTAs, with K1's
// epilogue where CENTER, on `stream`.  The block (the copy path LOAD, BN
// columns a CTA, kw rows of K of w held, `stages` ring slots) is
// ops/matmul.py::matmul_block's, checked here against what the kernel takes.
template <typename T, int LOAD, bool CENTER, int BN, bool STREAM = false>
cudaError_t launch(const void* x, const void* w, void* out, long long m, int k, int n, int out_bf16,
                   int kw, int stages, int ctas, const CenterArgs& ca, cudaStream_t stream) {
  using C = Cfg<T>;
  if (m < 1 || k < 1 || n < 1 || ctas < 1 || m > 0x7fffffffLL || stages < 2 ||
      stages > MAX_STAGES || (n + BN - 1) / BN > 65535) {
    return cudaErrorInvalidValue;
  }
  const bool kw_ok = STREAM         ? kw == C::KC
                     : LOAD == BULK ? kw == (k + 31) / 32 * 32  // whole groups, no panels
                                    : kw % C::KSTEP == 0 && (kw >= k || kw % C::KC == 0);
  const bool x_ok = LOAD == TMA    ? tma_ok<T>(x, k)
                    : LOAD == BULK ? reinterpret_cast<uintptr_t>(x) % 16 == 0
                                   : true;
  const long long smem = smem_bytes<T, BN, STREAM>(LOAD, k, kw, stages);
  if (!kw_ok || !x_ok || smem > SMEM_CAP) return cudaErrorInvalidValue;
  CUtensorMap map{};
  if constexpr (LOAD == TMA) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
    const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(T)};
    const cuuint32_t box[2] = {(cuuint32_t)C::KC, (cuuint32_t)BM};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(
        &map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
        const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem<T, LOAD, CENTER, BN, STREAM>();
  if (err != cudaSuccess) return err;
  matmul_tc<T, LOAD, CENTER, BN, STREAM>
      <<<grid_of(m, n, ctas, BN), THREADS, (size_t)smem, stream>>>(
          map, static_cast<const T*>(x), static_cast<const T*>(w), out, out_bf16, m, k, n, kw,
          stages, (int)slot_bytes(LOAD, k), ca);
  return cudaGetLastError();
}

// out (m x n, f32 or bf16) = x (m x k, f32, TMA-aligned) @ w (k x n, f32)
// with w streamed, 128 columns a CTA: split_w into w_split ((n / 128) cpt
// KC 128 8 bytes), then the streamed kernel on `stages` slots, on `s`.
template <bool CENTER>
cudaError_t launch_streamed(const void* x, const void* w, void* w_split, void* out, long long m,
                            int k, int n, int out_bf16, int stages, int ctas, const CenterArgs& ca,
                            cudaStream_t s) {
  if (m < 1 || k < 1 || n < 1 || w_split == nullptr) return cudaErrorInvalidValue;
  constexpr int KC = Cfg<float>::KC;
  const int cpt = (k + KC - 1) / KC;
  const long long threads = (long long)((n + 127) / 128) * cpt * (KC / 4) * 128;
  split_w<128><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(w), static_cast<uint32_t*>(w_split), k, n, cpt);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch<float, TMA, CENTER, 128, true>(x, w_split, out, m, k, n, out_bf16, KC, stages,
                                                ctas, ca, s);
}

// CTAs of the instantiation that fit one SM at once with `smem` bytes of
// dynamic shared memory, into *out.
template <typename T, int LOAD, bool CENTER, int BN, bool STREAM = false>
cudaError_t ctas_per_sm(int smem, int* out) {
  const cudaError_t err = allow_smem<T, LOAD, CENTER, BN, STREAM>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, matmul_tc<T, LOAD, CENTER, BN, STREAM>,
                                                       THREADS, smem);
}

// An instantiation's operand type, copy path and width, as a value.
template <typename T, int LOAD, int BN>
struct Kind {
  using type = T;
  static constexpr int load = LOAD;
  static constexpr int bn = BN;
};

// f(Kind<T, LOAD, BN>{}) for the instantiation of this operand type (bf16
// where x_bf16, else f32), copy path and width -- TMA at every width of
// the table, BULK (f32) at 24, 40 and 80, ELEM at 112 and 128 -- or
// cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t with_kind(int x_bf16, int load, int bn, F&& f) {
  if (x_bf16 && load == TMA) {
    switch (bn) {
      case 24: return f(Kind<bf16, TMA, 24>{});
      case 40: return f(Kind<bf16, TMA, 40>{});
      case 80: return f(Kind<bf16, TMA, 80>{});
      case 112: return f(Kind<bf16, TMA, 112>{});
      case 128: return f(Kind<bf16, TMA, 128>{});
    }
  } else if (x_bf16 && load == ELEM) {
    switch (bn) {
      case 112: return f(Kind<bf16, ELEM, 112>{});
      case 128: return f(Kind<bf16, ELEM, 128>{});
    }
  } else if (!x_bf16 && load == TMA) {
    switch (bn) {
      case 24: return f(Kind<float, TMA, 24>{});
      case 40: return f(Kind<float, TMA, 40>{});
      case 80: return f(Kind<float, TMA, 80>{});
      case 112: return f(Kind<float, TMA, 112>{});
      case 128: return f(Kind<float, TMA, 128>{});
    }
  } else if (!x_bf16 && load == BULK) {
    switch (bn) {
      case 24: return f(Kind<float, BULK, 24>{});
      case 40: return f(Kind<float, BULK, 40>{});
      case 80: return f(Kind<float, BULK, 80>{});
    }
  } else if (!x_bf16 && load == ELEM) {
    switch (bn) {
      case 112: return f(Kind<float, ELEM, 112>{});
      case 128: return f(Kind<float, ELEM, 128>{});
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace mm_tc
