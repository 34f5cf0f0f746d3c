// C = A^T B over the rows of two tall matrices on the tensor cores,
// f64-grade: the mainloop of K3 (C = Y^T X, project.cu), K4 (G = A^T A at
// "highest", gram.cu), K5 (the bf16-split Gram, gram.cu) and the G and C
// stages of K1 and K2 (sketch_center_gram_project.cu).
//
// A is M x NA and B is M x NB, both row-major.  The reduction runs over the
// rows, the slow axis of both: each operand is MN-major for the MMA.
//
// Work split.  A CTA (256 threads, 8 warps) owns one BT x BT block (bi, bj)
// of C and one share of the rows, which it walks in 128-row tiles
// (grid-stride over tiles by the number of shares).  Each tile's
// contribution is summed by the MMAs into f32 accumulators from zero, then
// added into f64 sums: an f32 running sum over a CTA's rows loses the
// noise-floor directions of a Gram matrix at ERA5 size.  At BT = 128 a
// thread holds 64 f32 accumulators; its 64 f64 sums would not fit beside
// them in 255 registers, so they live in shared memory (BT^2 doubles, each
// thread its own slots: no barrier, no bank conflict), read and written once
// per 128-row tile.  Each CTA writes its f64 block once into its share's
// slice of the scratch; atb_reduce sums the shares in a fixed order.  No
// atomics: C is identical from run to run.  With `upper` only the blocks
// bi <= bj of a symmetric product (A = B) are computed and the reduction
// mirrors the upper triangle, so G comes out exactly symmetric.  Block
// indices run fastest within a share and, for `upper`, row-major over the
// upper pairs, so CTAs next to one another in launch order share a row share
// and an A slice: the operand slabs that several CTAs read at about the same
// time come from L2.  A diagonal block of `upper` (bi = bj: A's slice is B's)
// in the wgmma kernels reads its slab once: its A fragments come from B's
// shared-memory copy, so it loads half the bytes and skips A's split.
//
// Accumulation.  The tensor core rounds its own sums toward zero: MMAs
// chained over a whole 128-row tile left a bias far above f32 rounding in a
// coherent sum.  So every 8 to 32 rows the MMAs start from zero, the small
// terms first, and their sum is added into the tile's f32 accumulators with
// round-to-nearest.
//
// Three kernels:
//   atb_wgmma_tf32x3  K3, K4 and K1's G and C on f32 operands, or one f32
//                     and one bf16: 3xTF32 on warpgroup MMAs, 128 x 128
//                     blocks.  A bf16 operand is widened to f32 as it is
//                     loaded; it is exact in tf32, so its lo term is
//                     dropped (two products).
//   atb_wgmma_bf16    the same on bf16 operands: one bf16 warpgroup MMA,
//                     128 x 128 blocks; the products are exact in f32.
//   atb_split_bf16    K5, f32 x f32 split in bf16: H = bf16(a), L = bf16(a -
//                     H), formed in registers as the fragments are loaded;
//                     L_i^T H_j + H_i^T L_j + H_i^T H_j by mma.sync m16n8k16
//                     bf16 (L^T L dropped, as in the JAX kernel); 64- or
//                     128-wide blocks, slabs staged by cp.async in a
//                     four-deep ring.
// The wgmma kernels read each slab into registers a slab ahead and store it
// into shared memory at the end of a slab: one instantiation in 16-byte (8
// for a bf16 operand of the 3xTF32 kernel) loads for rows aligned to them,
// one element by element for rows that are not.
// 3xTF32: hi = tf32(a) rounded to nearest, lo = a - hi (exact in f32, from
// the ROUNDED hi: the tensor core drops the 13 low bits it is handed),
// acc += lo.hi + hi.lo + hi.hi -- the counterpart of Precision.HIGHEST; one
// tf32 pass (~1e-3) would not be.
//
// Ranges: any M, NA and NB.  The wrapper sizes the scratch, n_share * NA *
// NB doubles, keeps it near 1 GiB and picks n_share so that the CTAs fill
// whole waves of the card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace atb_tc {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int MT = 128;  // rows per tile: summed in f32 from zero

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Sum the shares in share order (deterministic); with `upper` entry (r, c)
// is read from (min, max), which every CTA of the upper blocks wrote.
__global__ void atb_reduce(const double* __restrict__ part, float* __restrict__ out,
                           int n_share, int na, int nb, int upper) {
  const long long total = (long long)na * nb;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int r = (int)(i / nb);
  const int c = (int)(i % nb);
  const long long src = (upper && r > c) ? (long long)c * nb + r : i;
  double s = 0.0;
  for (int sh = 0; sh < n_share; ++sh) s += part[sh * total + src];
  out[i] = (float)s;
}

// op.run<A, B>() with A and B each float or bf16, chosen by the two flags.
template <typename Op>
cudaError_t dispatch(const Op& op, int a_bf16, int b_bf16) {
  if (a_bf16 && b_bf16) return op.template run<bf16, bf16>();
  if (a_bf16) return op.template run<bf16, float>();
  if (b_bf16) return op.template run<float, bf16>();
  return op.template run<float, float>();
}

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies of 16, 8 or 4 bytes that zero-fill the destination when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// tf32(v) rounded to nearest, ties away from zero: bit for bit what
// cvt.rna.tf32.f32 returns for a finite v, in two integer operations (the
// conversion instruction runs on the SM's narrow conversion pipe).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// hi = tf32_rna(v), lo = v - hi, exact in f32 and left to the tensor core,
// which drops its 13 low bits: a truncation of lo by at most 2^-11 |lo| <=
// 2^-22 |v|, the size of the dropped lo x lo term.  An EXACT operand (a bf16
// value) is its own hi.
template <bool EXACT = false>
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = tf32_rna(v);
    lo = __float_as_uint(v - __uint_as_float(hi));
  }
}

// (v0, v1) -> bf16x2 with v0 in the low half (the lower k of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float v0, float v1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(v1), "f"(v0));
  return r;
}

// H = bf16(v), L = bf16(v - H) for a pair; v - H is exact in f32.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  lo = pack_bf16(v0 - __uint_as_float(hi << 16), v1 - __uint_as_float(hi & 0xffff0000u));
}

// ------------------------------------------------- K5's split (mma.sync)

namespace split {
constexpr int WARPS_B = 4;  // warps along B's columns; 2 along A's
constexpr int STAGES = 4;   // slabs in the shared-memory ring

template <int BT>
struct Cfg {
  // rows per slab: 8 KB of A at BT 128; 64-wide blocks take twice the rows
  static constexpr int BK = BT == 64 ? 32 : 16;
  static constexpr int S = BT + 4;  // row stride of a slab, floats: see the fragment loads
  static constexpr int WARPS_A = THREADS / 32 / WARPS_B;
  static constexpr int WM = BT / WARPS_A;
  static constexpr int WN = BT / WARPS_B;
  static constexpr int MI = WM / 16;  // m16 tiles a warp
  static constexpr int NI = WN / 8;   // n8 tiles a warp
  static constexpr int ACC = MI * NI * 4;  // f32 accumulators a thread
  static constexpr int A_BYTES = BK * S * 4;
  static constexpr int STAGE_BYTES = 2 * A_BYTES;
  static constexpr int SUM_BYTES = ACC * THREADS * 8;
  static constexpr int SMEM = SUM_BYTES + STAGES * STAGE_BYTES;
  static_assert(MT % BK == 0 && A_BYTES % 16 == 0, "slab layout");
  static_assert(SMEM <= 232448, "shared memory of one CTA");
};
}  // namespace split

// Block (bi, bj) of C that CTA blockIdx.x owns, nbb blocks along B: with
// `upper` the pairs bi <= bj in row-major order (0,0), (0,1), ...,
// (0,nbb-1), (1,1), ...; else bi = idx / nbb, bj = idx % nbb.
__device__ __forceinline__ void block_of(int idx, int nbb, int upper, int& bi, int& bj) {
  if (upper) {
    bi = 0;
    while (idx >= nbb - bi) {
      idx -= nbb - bi;
      ++bi;
    }
    bj = bi + idx;
  } else {
    bi = idx / nbb;
    bj = idx % nbb;
  }
}

// Rows [r0, r0 + BK) and columns [c0, c0 + BT) of src (ncols wide) into a
// slab of row stride S, in cp.async copies of BYTES (16 or 8) that are
// wholly in or out of range (ncols is a multiple of BYTES / 4);
// out-of-range elements are zero.
template <int BYTES, int BT, int BK, int S>
__device__ __forceinline__ void stage_runs(float* dst, const float* __restrict__ src, long long r0,
                                           long long m, int ncols, int c0, int tid) {
  constexpr int VEC = BYTES / 4;
  constexpr int CPR = BT / VEC;
#pragma unroll(BYTES == 16 ? 8 : 1)  // the 8-byte path rolled: K5's 64-wide kernel has 128 registers
  for (int i = tid; i < BK * CPR; i += THREADS) {
    const int k = i / CPR;
    const int c = (i % CPR) * VEC;
    const long long gr = r0 + k;
    const bool ok = gr < m && c0 + c < ncols;
    const float* p = ok ? src + gr * ncols + c0 + c : src;
    if constexpr (BYTES == 16) {
      cp_async16(smem_u32(dst + k * S + c), p, ok);
    } else {
      cp_async8(smem_u32(dst + k * S + c), p, ok);
    }
  }
}

// The same with copies as wide as the rows' alignment allows: `width` is
// 16, 8, or 0 for single elements.
template <int BT, int BK, int S>
__device__ __forceinline__ void stage_slab(float* dst, const float* __restrict__ src, long long r0,
                                           long long m, int ncols, int c0, int width, int tid) {
  if (width == 16) {
    stage_runs<16, BT, BK, S>(dst, src, r0, m, ncols, c0, tid);
  } else if (width == 8) {
    stage_runs<8, BT, BK, S>(dst, src, r0, m, ncols, c0, tid);
  } else {
#pragma unroll 4
    for (int i = tid; i < BK * BT; i += THREADS) {
      const int k = i / BT;
      const int c = i % BT;
      const long long gr = r0 + k;
      const bool ok = gr < m && c0 + c < ncols;
      cp_async4(smem_u32(dst + k * S + c), ok ? src + gr * ncols + c0 + c : src, ok);
    }
  }
}

// One slab's split products into acc.  as / bs: the slabs, [BK][S]; the
// warp's tile starts at row wm0 of A's block and column wn0 of B's.
// m16n8k16 fragments, k in pairs (2t, 2t+1) and (2t+8, 2t+9): with S % 32
// == 4 the lanes' (k = 2t or 2t+1, col g) hit 32 distinct banks.  Each
// k16 step's MMAs start from zero, the small terms first, and only their
// sum enters acc, in f32 rounded to nearest.
template <int BT>
__device__ __forceinline__ void split_products(
    float (&acc)[split::Cfg<BT>::MI][split::Cfg<BT>::NI][4], const float* as, const float* bs,
    int wm0, int wn0, int lane) {
  using C = split::Cfg<BT>;
  constexpr int S = C::S;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < C::BK; k0 += 16) {
    uint32_t bh[C::NI][2], bl[C::NI][2];
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      const float* p = bs + (k0 + 2 * t) * S + wn0 + ni * 8 + g;
      split_bf16(p[0], p[S], bh[ni][0], bl[ni][0]);
      split_bf16(p[8 * S], p[9 * S], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
      const float* p = as + (k0 + 2 * t) * S + wm0 + mi * 16 + g;
      uint32_t ah[4], al[4];
      split_bf16(p[0], p[S], ah[0], al[0]);
      split_bf16(p[8], p[S + 8], ah[1], al[1]);
      split_bf16(p[8 * S], p[9 * S], ah[2], al[2]);
      split_bf16(p[8 * S + 8], p[9 * S + 8], ah[3], al[3]);
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, al, bh[ni]);
        mma_bf16(d, ah, bl[ni]);
        mma_bf16(d, ah, bh[ni]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += d[q];
      }
    }
  }
}

// Two CTAs an SM at BT = 64 (at most 128 registers a thread), one at 128.
template <int BT>
__global__ void __launch_bounds__(THREADS, BT == 64 ? 2 : 1)
    atb_split_bf16(const float* __restrict__ a, const float* __restrict__ b,
                   double* __restrict__ part, long long m, int na, int nb, int upper,
                   int n_share, int width_a, int width_b) {
  using C = split::Cfg<BT>;
  constexpr int SPT = MT / C::BK;  // slabs a tile
  constexpr int STAGES = split::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  double* sums = reinterpret_cast<double*>(smem);  // [ACC][THREADS]
  unsigned char* ring = smem + C::SUM_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = (warp / split::WARPS_B) * C::WM;
  const int wn0 = (warp % split::WARPS_B) * C::WN;
  const int nbb = (nb + BT - 1) / BT;
  int bi, bj;
  block_of(blockIdx.x, nbb, upper, bi, bj);
  const int a0 = bi * BT;
  const int b0 = bj * BT;
  const int share = blockIdx.y;
  const long long n_tiles = (m + MT - 1) / MT;
  const long long my_tiles = share < n_tiles ? (n_tiles - share + n_share - 1) / n_share : 0;
  const long long n_slabs = my_tiles * SPT;

#pragma unroll
  for (int i = 0; i < C::ACC; ++i) sums[i * THREADS + tid] = 0.0;
  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  // slab s of this share: tile share + (s / SPT) n_share, rows (s % SPT) BK on
  auto stage = [&](long long s) {
    const long long r0 = (share + (s / SPT) * n_share) * MT + (s % SPT) * C::BK;
    unsigned char* st = ring + (int)(s % STAGES) * C::STAGE_BYTES;
    stage_slab<BT, C::BK, C::S>(reinterpret_cast<float*>(st), a, r0, m, na, a0, width_a, tid);
    stage_slab<BT, C::BK, C::S>(reinterpret_cast<float*>(st + C::A_BYTES), b, r0, m, nb, b0,
                                width_b, tid);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slabs) stage(s);
    cp_async_commit();
  }
  int in_tile = 0;  // s % SPT
  int slot = 0;     // s % STAGES
  for (long long s = 0; s < n_slabs; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slab s have landed
    __syncthreads();              // ... everyone's; and slab s - 1 is consumed
    if (s + STAGES - 1 < n_slabs) stage(s + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = ring + slot * C::STAGE_BYTES;
    split_products<BT>(acc, reinterpret_cast<const float*>(st),
                       reinterpret_cast<const float*>(st + C::A_BYTES), wm0, wn0, lane);
    if (++in_tile == SPT) {  // end of a 128-row tile: into the f64 sums
      in_tile = 0;
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sums[((mi * C::NI + ni) * 4 + q) * THREADS + tid] += (double)acc[mi][ni][q];
            acc[mi][ni][q] = 0.f;
          }
    }
    if (++slot == STAGES) slot = 0;
  }
  cp_async_wait<0>();

  // accumulator q of tile (mi, ni): row g (+8 for q >= 2), column 2t + (q & 1)
  const int g = lane >> 2;
  const int t = lane & 3;
  double* dst = part + (size_t)share * na * nb;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = a0 + wm0 + mi * 16 + g + (q >> 1) * 8;
        const int c = b0 + wn0 + ni * 8 + 2 * t + (q & 1);
        if (r < na && c < nb) {
          dst[(size_t)r * nb + c] = sums[((mi * C::NI + ni) * 4 + q) * THREADS + tid];
        }
      }
}

// ------------------------------------- 3xTF32 on wgmma (atb_wgmma_tf32x3)
//
// K3's, K4's and K1's f32 products: 3xTF32 on warpgroup MMAs, which run
// asynchronously beside the splitting and at twice the tf32 rate mma.sync
// reaches.  Each warpgroup holds its A operand in registers (a warp's 16
// rows, loaded from the MN-major raw slab and split there, lo left to the
// tensor core's truncation), and B comes from shared memory, where tf32
// wgmma wants it K-major: each 16-row slab of B is split once a CTA into hi
// and lo planes of 8 x 16-byte core matrices, transposed on the way, while
// the previous slab's MMAs run.  Two block edges:
//   BT 128  the two warpgroups own rows 0-63 and 64-127 of a 128 x 128
//           block; per slab, from zero: D = A_lo B_hi + A_hi B_lo over both
//           k8 steps, then + A_hi B_hi of each (six m64n128k8 MMAs).
//   BT 64   both own the 64 rows of a 64 x 64 block, warpgroup w the k8
//           step w of each slab: D = A_lo B_hi + A_hi B_lo + A_hi B_hi
//           (three m64n64k8 MMAs); their f64 sums are added, in warpgroup
//           order, as the block is written.  Half the registers: two CTAs
//           an SM.
// The small terms go first, so only the last MMAs round a large D toward
// zero; a bf16 operand has no lo, and its products go.  Then acc += D in
// f32, and the f64 sums every 128 rows.  Raw slabs of A and B are read into
// registers a slab ahead (B two, since it is split a slab before its MMAs),
// widened to f32, and stored into two shared slots each at the end of a
// slab.
namespace wg {
constexpr int BT = 128;  // the block edge of the bf16 kernel and of 3xTF32's default
constexpr int BK = 16;   // rows per slab: two k8 steps
constexpr int SPT = MT / BK;
constexpr int RING = 2;  // raw slabs of A, and of B, in shared memory
constexpr int SUM_BYTES = 64 * THREADS * 8;  // 64 f64 sums a thread at BT 128
}  // namespace wg

// atb_wgmma_tf32x3's layout at block edge BT (128 or 64).
template <int BT>
struct Tf32Cfg {
  static constexpr int S = BT + 8;           // raw row stride, floats: S % 32 == 8
  static constexpr int SLAB = wg::BK * S;    // floats
  static constexpr int PLANE = BT * wg::BK;  // words: core matrices of 8 x 4 tf32
  static constexpr int NACC = BT / 2;        // f32 accumulators a thread: m64 x nBT
  static constexpr int RPR = BT / 4;         // runs of four columns a slab row
  static constexpr int RUNS = BT / 64;       // runs of a slab a thread loads
  static constexpr int SUM_BYTES = NACC * THREADS * 8;
  static constexpr int SMEM = SUM_BYTES + 2 * wg::RING * SLAB * 4 + 2 * 2 * PLANE * 4;
  static_assert(S % 32 == 8 && RUNS * THREADS * 4 == wg::BK * BT, "slab layout");
  static_assert(SMEM * (BT == 64 ? 2 : 1) <= 232448, "shared memory of the CTAs of an SM");
};

// Shared-memory descriptor of a K-major operand without swizzle: core
// matrices of 8 rows x 16 bytes, the next along K 128 bytes on (leading
// byte offset), the next 8 rows BK / 4 core matrices on (stride byte offset).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(wg::BK / 4 * 128 >> 4) << 32);
}

// d (+)= a b: a 64 x 8 tf32 slice in registers (a warp's 16 rows in the
// mma.m16n8k8 layout), b 8 x 128 from a descriptor; d as 16 n8 tiles of the
// m16n8 accumulator layout.  scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The same at n 64: d as 8 n8 tiles.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Registers that an in-flight wgmma reads or writes: the compiler must
// neither reuse nor read them before the wait.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&r)[4]) {
  asm volatile("" : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])::"memory");
}

// Four neighbouring elements at p in f32: one 16-byte (f32) or 8-byte
// (bf16) load.
__device__ __forceinline__ float4 load_vec4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_vec4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// This thread's runs of four columns of a 16-row slab from row r0 of src
// (m x ncols, row-major), in f32, BT columns from c0: run q = i THREADS +
// tid is row q / RPR, columns c0 + 4 (q % RPR); zero past the edges and
// unless live.  Where every row is aligned to a run (VEC; then ncols is a
// multiple of 4) a run is one load, wholly in or out of range; else
// element by element.
template <int BT, bool VEC, typename T>
__device__ __forceinline__ void load_slab(const T* __restrict__ src, long long r0, long long m,
                                          int ncols, int c0, bool live, int tid,
                                          float4 (&v)[Tf32Cfg<BT>::RUNS]) {
  using C = Tf32Cfg<BT>;
#pragma unroll
  for (int i = 0; i < C::RUNS; ++i) {
    const int q = i * THREADS + tid;
    const int c = c0 + (q % C::RPR) * 4;
    const long long gr = r0 + q / C::RPR;
    if constexpr (VEC) {
      v[i] = (live && gr < m && c < ncols) ? load_vec4(src + gr * ncols + c)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const T* p = src + gr * ncols + c;
      const bool ok = live && gr < m;
      v[i].x = ok && c < ncols ? to_f32(p[0]) : 0.f;
      v[i].y = ok && c + 1 < ncols ? to_f32(p[1]) : 0.f;
      v[i].z = ok && c + 2 < ncols ? to_f32(p[2]) : 0.f;
      v[i].w = ok && c + 3 < ncols ? to_f32(p[3]) : 0.f;
    }
  }
}

// TA, TB: float, or one of them bf16 (bf16 x bf16 takes atb_wgmma_bf16).
// VEC: every row of A and B is aligned to a run of four elements, loaded
// at once (a runtime choice in the loads cost this kernel ~4% on an H100).
// BT: the block edge, 128 or 64 (the note above).
template <typename TA, typename TB, bool VEC, int BT>
__global__ void __launch_bounds__(THREADS, BT == 64 ? 2 : 1)
    atb_wgmma_tf32x3(const TA* __restrict__ a, const TB* __restrict__ b,
                     double* __restrict__ part, long long m, int na, int nb, int upper,
                     int n_share, int width_a, int width_b) {
  using C = Tf32Cfg<BT>;
  constexpr int NACC = C::NACC;
  constexpr bool A_EXACT = sizeof(TA) == 2;  // bf16: its own hi, no lo
  constexpr bool B_EXACT = sizeof(TB) == 2;
  constexpr int KCS = BT == 128 ? 2 : 1;  // k8 steps of a slab a warpgroup takes
  static_assert(!(A_EXACT && B_EXACT), "bf16 x bf16 is atb_wgmma_bf16");
  extern __shared__ __align__(16) unsigned char smem[];
  double* sums = reinterpret_cast<double*>(smem);  // [NACC][THREADS]
  float* ring_a = reinterpret_cast<float*>(smem + C::SUM_BYTES);
  float* ring_b = ring_a + wg::RING * C::SLAB;  // raw slabs s % 2
  uint32_t* planes = reinterpret_cast<uint32_t*>(ring_b + wg::RING * C::SLAB);  // [2][hi, lo]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the warp's rows of A's block; at BT 64 its warpgroup's k8 step
  const int row0 = (BT == 128 ? (warp >> 2) * 64 : 0) + (warp & 3) * 16;
  const int kc0 = BT == 128 ? 0 : warp >> 2;
  const int nbb = (nb + BT - 1) / BT;
  int bi, bj;
  block_of(blockIdx.x, nbb, upper, bi, bj);
  const int a0 = bi * BT;
  const int b0 = bj * BT;
  // A's slab is B's: read once, A's fragments from B's planes
  const bool diag = std::is_same<TA, TB>::value && upper && bi == bj;
  const int share = blockIdx.y;
  const long long n_tiles = (m + MT - 1) / MT;
  const long long my_tiles = share < n_tiles ? (n_tiles - share + n_share - 1) / n_share : 0;
  const long long n_slabs = my_tiles * wg::SPT;

#pragma unroll
  for (int i = 0; i < NACC; ++i) sums[i * THREADS + tid] = 0.0;
  float acc[NACC], d[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = d[i] = 0.f;

  auto rows = [&](long long s) {
    return (share + (s / wg::SPT) * n_share) * MT + (s % wg::SPT) * wg::BK;
  };
  // raw B slab s -> planes s % 2: element (k, n) of core matrix c = (n / 8)
  // (BK / 4) + k / 4 at word c 32 + (n % 8) 4 + k % 4.  A thread splits the
  // four k of one n that share 16 bytes of a core matrix: its warp reads 32
  // neighbouring n of a raw row and writes four whole core-matrix rows, both
  // conflict-free.
  auto split_b = [&](long long s) {
    const float* raw = ring_b + (s & 1) * C::SLAB;
    uint32_t* hi = planes + (int)(s & 1) * 2 * C::PLANE;
#pragma unroll
    for (int i = 0; i < C::PLANE / 4 / THREADS; ++i) {
      const int q = i * THREADS + tid;
      const int n = q % BT;
      const int kb = q / BT;
      uint4 h, l;
      split_tf32<B_EXACT>(raw[(4 * kb) * C::S + n], h.x, l.x);
      split_tf32<B_EXACT>(raw[(4 * kb + 1) * C::S + n], h.y, l.y);
      split_tf32<B_EXACT>(raw[(4 * kb + 2) * C::S + n], h.z, l.z);
      split_tf32<B_EXACT>(raw[(4 * kb + 3) * C::S + n], h.w, l.w);
      const int w = ((n >> 3) * (wg::BK / 4) + kb) * 32 + (n & 7) * 4;
      *reinterpret_cast<uint4*>(hi + w) = h;
      *reinterpret_cast<uint4*>(hi + C::PLANE + w) = l;
    }
  };
  // this warp's A fragments of k8 step kc of raw A slab s; on a diagonal
  // block, of B's planes of slab s, already split: (k, n) at the word above,
  // so the lanes read 32 neighbouring words
  auto a_frags = [&](long long s, int kc, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    if (diag) {
      constexpr int N8 = wg::BK / 4 * 32;  // words from row n to n + 8
      const uint32_t* hi =
          planes + (int)(s & 1) * 2 * C::PLANE + ((row0 >> 3) * N8) + kc * 64 + g * 4 + t;
      ah[0] = hi[0];
      ah[1] = hi[N8];
      ah[2] = hi[32];
      ah[3] = hi[N8 + 32];
      al[0] = hi[C::PLANE];
      al[1] = hi[C::PLANE + N8];
      al[2] = hi[C::PLANE + 32];
      al[3] = hi[C::PLANE + N8 + 32];
      return;
    }
    const float* as = ring_a + (s & 1) * C::SLAB + (kc * 8 + t) * C::S + row0 + g;
    split_tf32<A_EXACT>(as[0], ah[0], al[0]);
    split_tf32<A_EXACT>(as[8], ah[1], al[1]);
    split_tf32<A_EXACT>(as[4 * C::S], ah[2], al[2]);
    split_tf32<A_EXACT>(as[4 * C::S + 8], ah[3], al[3]);
  };

  // A s + 1 and B s + 2 are read into registers during slab s and stored
  // at its end (cp.async copies into a deeper ring ran markedly slower in
  // this kernel on an H100)
  float4 va[C::RUNS], vb[C::RUNS];
  auto ldg_a = [&](long long s) {
    if (!diag) load_slab<BT, VEC>(a, rows(s), m, na, a0, s < n_slabs, tid, va);
  };
  auto ldg_b = [&](long long s) {
    load_slab<BT, VEC>(b, rows(s), m, nb, b0, s < n_slabs, tid, vb);
  };
  auto sts = [&](float* ring, long long s, const float4 (&v)[C::RUNS]) {
#pragma unroll
    for (int i = 0; i < C::RUNS; ++i) {
      const int q = i * THREADS + tid;
      *reinterpret_cast<float4*>(ring + (s & 1) * C::SLAB + (q / C::RPR) * C::S +
                                 (q % C::RPR) * 4) = v[i];
    }
  };
  ldg_a(0);
  if (!diag) sts(ring_a, 0, va);
  ldg_b(0);
  sts(ring_b, 0, vb);
  ldg_b(1);
  sts(ring_b, 1, vb);
  __syncthreads();
  if (n_slabs > 0) split_b(0);
  fence_proxy_async();
  ldg_a(1);
  ldg_b(2);

  int in_tile = 0;
  for (long long s = 0; s < n_slabs; ++s) {
    __syncthreads();  // planes s % 2, A s and B s + 1 in place; slab s - 1 done with
    uint32_t ah[KCS][4], al[KCS][4];
#pragma unroll
    for (int q = 0; q < KCS; ++q) a_frags(s, kc0 + q, ah[q], al[q]);
    const uint32_t p_hi = smem_u32(planes + (int)(s & 1) * 2 * C::PLANE);
    hold(d);
    wgmma_fence();
    // the small terms first, then the large ones; the first starts D from
    // zero.  k8 step kc: core matrices 2 kc and 2 kc + 1 along K
#pragma unroll
    for (int q = 0; q < KCS; ++q) {
      const uint32_t hi = p_hi + (kc0 + q) * 256;
      const uint64_t hi_d = kmajor_desc(hi);
      const uint64_t lo_d = kmajor_desc(hi + C::PLANE * 4);
      if constexpr (B_EXACT) {
        wgmma_tf32(d, al[q], hi_d, q == 0 ? 0 : 1);
      } else if constexpr (A_EXACT) {
        wgmma_tf32(d, ah[q], lo_d, q == 0 ? 0 : 1);
      } else {
        wgmma_tf32(d, al[q], hi_d, q == 0 ? 0 : 1);
        wgmma_tf32(d, ah[q], lo_d, 1);
      }
    }
#pragma unroll
    for (int q = 0; q < KCS; ++q) wgmma_tf32(d, ah[q], kmajor_desc(p_hi + (kc0 + q) * 256), 1);
    wgmma_commit();
    if (s + 1 < n_slabs) split_b(s + 1);  // beside the MMAs
    fence_proxy_async();
    wgmma_wait<0>();
    hold(d);
#pragma unroll
    for (int q = 0; q < KCS; ++q) {
      hold(ah[q]);
      if constexpr (!A_EXACT) hold(al[q]);
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += d[i];
    if (++in_tile == wg::SPT) {  // end of a 128-row tile: into the f64 sums
      in_tile = 0;
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        sums[i * THREADS + tid] += (double)acc[i];
        acc[i] = 0.f;
      }
    }
    if (!diag) sts(ring_a, s + 1, va);
    sts(ring_b, s + 2, vb);
    ldg_a(s + 2);
    ldg_b(s + 3);
  }

  // accumulator 4j + q: row g (+8 for q >= 2) of the warp's 16, column 8j +
  // 2t + (q & 1).  At BT 64 warpgroup 1's sums of the same entries are added
  // to warpgroup 0's, which writes them.
  if constexpr (BT == 64) {
    __syncthreads();
    if (warp >= 4) return;
  }
  double* dst = part + (size_t)share * na * nb;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int r = a0 + row0 + g + ((i & 3) >> 1) * 8;
    const int c = b0 + (i >> 2) * 8 + 2 * t + (i & 1);
    double v = sums[i * THREADS + tid];
    if constexpr (BT == 64) v += sums[i * THREADS + tid + THREADS / 2];
    if (r < na && c < nb) dst[(size_t)r * nb + c] = v;
  }
}

// -------------------------------------- bf16 x bf16 on wgmma (atb_wgmma_bf16)
//
// K3 at the d = 3 pass: the same two warpgroups and 128 x 128 block as
// atb_wgmma_tf32x3, no split.  A (a warp's 16 rows) comes from the MN-major
// raw slab by ldmatrix.trans; B stays MN-major and wgmma transposes it
// (imm-trans-b): the register-staged loads store each 16-byte run of 8
// columns straight into 8 x 8 core matrices, a slab's 32 rows as 4 x 16 of
// them.  Per slab, from zero: D = A B over its two k16 steps, then acc += D.
namespace wgb {
constexpr int BK = 32;  // rows per slab: two k16 steps
constexpr int SPT = MT / BK;
constexpr int S = wg::BT + 8;               // raw A row stride, bf16: 272 bytes
constexpr int A_SLAB = BK * S;              // bf16 elements
constexpr int B_SLAB = BK * wg::BT;         // bf16 elements: 64 core matrices
constexpr int K_STRIDE = wg::BT / 8 * 128;  // bytes between core matrices along K
constexpr int SMEM = wg::SUM_BYTES + 2 * (A_SLAB + B_SLAB) * 2;
static_assert(SMEM <= 232448, "shared memory of one CTA");
}  // namespace wgb

// MN-major B without swizzle: core matrices of 8 k-rows x 16 bytes, the next
// along K K_STRIDE bytes on (leading byte offset), the next along N 128
// bytes on (stride byte offset).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(wgb::K_STRIDE >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// VEC: every row of A and B is 16-byte aligned, 8 columns loaded at once.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    atb_wgmma_bf16(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   double* __restrict__ part, long long m, int na, int nb, int upper,
                   int n_share, int width_a, int width_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* sums = reinterpret_cast<double*>(smem);  // [64][THREADS]
  bf16* ring_a = reinterpret_cast<bf16*>(smem + wg::SUM_BYTES);  // raw slabs s % 2
  bf16* ring_b = ring_a + 2 * wgb::A_SLAB;                        // core matrices, s % 2

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (warp >> 2) * 64 + (warp & 3) * 16;
  const int nbb = (nb + wg::BT - 1) / wg::BT;
  int bi, bj;
  block_of(blockIdx.x, nbb, upper, bi, bj);
  const int a0 = bi * wg::BT;
  const int b0 = bj * wg::BT;
  const bool diag = upper && bi == bj;  // A's slab is B's: read once, A from B's core matrices
  const int share = blockIdx.y;
  const long long n_tiles = (m + MT - 1) / MT;
  const long long my_tiles = share < n_tiles ? (n_tiles - share + n_share - 1) / n_share : 0;
  const long long n_slabs = my_tiles * wgb::SPT;

#pragma unroll
  for (int i = 0; i < 64; ++i) sums[i * THREADS + tid] = 0.0;
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;

  auto rows = [&](long long s) {
    return (share + (s / wgb::SPT) * n_share) * MT + (s % wgb::SPT) * wgb::BK;
  };
  // 16-byte runs of a slab, two a thread.  A: run q is row q / 16, columns
  // 8 (q % 16).  B: run q is row 8 (q / 128) + q % 8, columns 8 ((q / 8) %
  // 16), so 8 neighbouring lanes fill one core matrix (128 contiguous bytes)
  // and a warp reads 64 contiguous bytes of each of 8 rows.
  // Where the rows are not 16-byte aligned, element by element.
  auto ldg = [&](const bf16* src, int ncols, int c0, long long s, bool is_b, uint4 (&v)[2]) {
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = i * THREADS + tid;
        const int k = is_b ? (q >> 7) * 8 + (q & 7) : q >> 4;
        const int c = is_b ? ((q >> 3) & 15) * 8 : (q & 15) * 8;
        const long long gr = rows(s) + k;
        v[i] = (s < n_slabs && gr < m && c0 + c < ncols)
                   ? __ldg(reinterpret_cast<const uint4*>(src + gr * ncols + c0 + c))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = i * THREADS + tid;
        const int k = is_b ? (q >> 7) * 8 + (q & 7) : q >> 4;
        const int c = c0 + (is_b ? ((q >> 3) & 15) * 8 : (q & 15) * 8);
        const long long gr = rows(s) + k;
        const bool ok = s < n_slabs && gr < m;
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t lo = ok && c + 2 * j < ncols ? h[gr * ncols + c + 2 * j] : 0u;
          const uint32_t hi = ok && c + 2 * j + 1 < ncols ? h[gr * ncols + c + 2 * j + 1] : 0u;
          w[j] = lo | (hi << 16);
        }
        v[i] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };
  auto sts_a = [&](long long s, const uint4 (&v)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = i * THREADS + tid;
      *reinterpret_cast<uint4*>(ring_a + (s & 1) * wgb::A_SLAB + (q >> 4) * wgb::S + (q & 15) * 8) =
          v[i];
    }
  };
  auto sts_b = [&](long long s, const uint4 (&v)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = i * THREADS + tid;  // core matrix (k / 8, n / 8), row k % 8
      const int off = ((q >> 7) * 16 + ((q >> 3) & 15)) * 64 + (q & 7) * 8;
      *reinterpret_cast<uint4*>(ring_b + (s & 1) * wgb::B_SLAB + off) = v[i];
    }
  };
  uint4 va[2], vb[2];
  if (!diag) {
    ldg(a, na, a0, 0, false, va);
    sts_a(0, va);
  }
  ldg(b, nb, b0, 0, true, vb);
  sts_b(0, vb);
  if (!diag) ldg(a, na, a0, 1, false, va);
  ldg(b, nb, b0, 1, true, vb);

  const int j = lane >> 3;  // ldmatrix: lane addresses row lane % 8 of matrix lane / 8
  const int r = lane & 7;
  int in_tile = 0;
  for (long long s = 0; s < n_slabs; ++s) {
    fence_proxy_async();  // this thread's stores of slab s, to wgmma's reads
    __syncthreads();      // slab s in place; slab s - 1 done with
    uint32_t af0[4], af1[4];
    if (diag) {  // row r of k block kb of core matrix (kb, n / 8) of B's slab
      const bf16* bs = ring_b + (s & 1) * wgb::B_SLAB + ((j >> 1) * 16 + (row0 >> 3) + (j & 1)) * 64 + r * 8;
      ldsm_x4_trans(smem_u32(bs), af0[0], af0[1], af0[2], af0[3]);
      ldsm_x4_trans(smem_u32(bs + 2 * 16 * 64), af1[0], af1[1], af1[2], af1[3]);
    } else {
      const bf16* as = ring_a + (s & 1) * wgb::A_SLAB + row0 + (j & 1) * 8;
      ldsm_x4_trans(smem_u32(as + ((j >> 1) * 8 + r) * wgb::S), af0[0], af0[1], af0[2], af0[3]);
      ldsm_x4_trans(smem_u32(as + (16 + (j >> 1) * 8 + r) * wgb::S), af1[0], af1[1], af1[2],
                    af1[3]);
    }
    const uint32_t pb = smem_u32(ring_b + (s & 1) * wgb::B_SLAB);
    hold(d);
    wgmma_fence();
    wgmma_bf16(d, af0, mnmajor_desc(pb), 0);                      // rows 0-15 of the slab
    wgmma_bf16(d, af1, mnmajor_desc(pb + 2 * wgb::K_STRIDE), 1);  // rows 16-31
    wgmma_commit();
    if (!diag) sts_a(s + 1, va);  // the other slots, free since the barrier
    sts_b(s + 1, vb);
    if (!diag) ldg(a, na, a0, s + 2, false, va);
    ldg(b, nb, b0, s + 2, true, vb);
    wgmma_wait<0>();
    hold(d);
    hold(af0);
    hold(af1);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
    if (++in_tile == wgb::SPT) {  // end of a 128-row tile: into the f64 sums
      in_tile = 0;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sums[i * THREADS + tid] += (double)acc[i];
        acc[i] = 0.f;
      }
    }
  }

  double* dst = part + (size_t)share * na * nb;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int rr = a0 + row0 + g + ((i & 3) >> 1) * 8;
    const int c = b0 + (i >> 2) * 8 + 2 * t + (i & 1);
    if (rr < na && c < nb) dst[(size_t)rr * nb + c] = sums[i * THREADS + tid];
  }
}

// Widest copy, in bytes, that every row of p (ncols wide) is aligned to:
// 16, 8, or 0 (element by element).
template <typename T>
inline int row_copy_bytes(const T* p, int ncols) {
  const long long row = (long long)ncols * sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(p);
  if (base % 16 == 0 && row % 16 == 0) return 16;
  if (base % 8 == 0 && row % 8 == 0) return 8;
  return 0;
}

// A main kernel, the shared memory it takes, the edge of its blocks of C,
// and whether it takes `upper`.
template <typename TA, typename TB>
struct Main {
  void (*kernel)(const TA*, const TB*, double*, long long, int, int, int, int, int, int);
  int smem;
  int edge;
  bool upper;
};

// K5's split product at block edge BT (64 or 128).
template <int BT>
Main<float, float> split_main() {
  return {atb_split_bf16<BT>, split::Cfg<BT>::SMEM, BT, true};
}

// Whether every row of a and b is aligned to one load of the wgmma kernels
// for these types: 16 bytes, 8 for a bf16 operand beside an f32 one.
template <typename TA, typename TB>
bool wgmma_rows_aligned(const TA* a, int na, const TB* b, int nb) {
  constexpr bool BF16 = sizeof(TA) == 2 && sizeof(TB) == 2;
  return row_copy_bytes(a, na) >= (BF16 ? 16 : 4 * (int)sizeof(TA)) &&
         row_copy_bytes(b, nb) >= (BF16 ? 16 : 4 * (int)sizeof(TB));
}

// The wgmma product for its operand types (K3, K4 at "highest", K1's G and
// C): one bf16 pass for bf16 x bf16 (128 x 128 blocks), else 3xTF32 (two
// products where one operand is bf16) at block edge EDGE, 128 or 64;
// `aligned` from wgmma_rows_aligned.  One operand type takes `upper` (A = B,
// a Gram matrix).
template <typename TA, typename TB, int EDGE = wg::BT>
Main<TA, TB> wgmma_main(bool aligned) {
  if constexpr (sizeof(TA) == 2 && sizeof(TB) == 2) {
    static_assert(EDGE == wg::BT, "the bf16 kernel's blocks are 128 wide");
    return {aligned ? &atb_wgmma_bf16<true> : &atb_wgmma_bf16<false>, wgb::SMEM, wg::BT, true};
  } else {
    return {aligned ? &atb_wgmma_tf32x3<TA, TB, true, EDGE> : &atb_wgmma_tf32x3<TA, TB, false, EDGE>,
            Tf32Cfg<EDGE>::SMEM, EDGE, std::is_same<TA, TB>::value};
  }
}

// The block edge of the wgmma Gram (K4 at "highest", K1's G stage) at width
// k: the table in gram.cu (64-wide blocks pay where 128-wide ones would be
// mostly padding).
inline int gram_edge(bool bf16, int k) { return !bf16 && k > 128 && k <= 192 ? 64 : wg::BT; }

// Blocks bi <= bj of a k x k Gram matrix in blocks of edge x edge.
inline int upper_blocks(int k, int edge) {
  const int nb = (k + edge - 1) / edge;
  return nb * (nb + 1) / 2;
}

// op(the wgmma Gram's kernel for T at width k): 3xTF32 for f32 at the block
// edge of gram_edge, one bf16 pass for bf16 (128-wide blocks); `aligned`
// from wgmma_rows_aligned.
template <typename T, typename Op>
cudaError_t with_gram_main(bool aligned, int k, const Op& op) {
  if constexpr (sizeof(T) == 2) {
    return op(wgmma_main<T, T>(aligned));
  } else {
    return gram_edge(false, k) == 64 ? op(wgmma_main<T, T, 64>(aligned))
                                     : op(wgmma_main<T, T, 128>(aligned));
  }
}

// Launches k's kernel and atb_reduce on `stream`; returns a
// cudaError_t code.  part: n_share * na * nb doubles.  `upper`: a is b.
template <typename TA, typename TB>
cudaError_t launch(const Main<TA, TB>& k, const TA* a, const TB* b, double* part, float* out,
                   long long m, int na, int nb, int upper, int n_share, cudaStream_t stream) {
  if (m < 1 || na < 1 || nb < 1 || n_share < 1 || n_share > 65535 ||
      (upper && (na != nb || !k.upper || (const void*)a != (const void*)b))) {
    return cudaErrorInvalidValue;
  }
  const long long nba = (na + k.edge - 1) / k.edge;
  const long long nbb = (nb + k.edge - 1) / k.edge;
  const long long n_blocks = upper ? nbb * (nbb + 1) / 2 : nba * nbb;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto kernel = k.kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)n_blocks, n_share), THREADS, k.smem, stream>>>(
      a, b, part, m, na, nb, upper, n_share, row_copy_bytes(a, na), row_copy_bytes(b, nb));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)na * nb;
  atb_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, out, n_share, na,
                                                                      nb, upper);
  return cudaGetLastError();
}

// CTAs of k's kernel that fit one SM at once, into *out.
template <typename TA, typename TB>
cudaError_t ctas_per_sm(const Main<TA, TB>& k, int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(k.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k.kernel, THREADS, k.smem);
}

}  // namespace atb_tc
