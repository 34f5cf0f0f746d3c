// K6 on Hopper: out = x @ w, summed in f32, on the tensor cores.
//
// Replaces the Pallas kernel dmd_era5_tpu/ops/matmul.py::_matmul_kernel
// (:79, behind matmul, :101), the per-block sketch of the out-of-core SVD
// (dmd_era5_tpu/pipeline/streamed_fit.py:166-185): each streamed row block
// X_blk (65,536 x 168 at ERA5-week size) times the (168 x 110) iterate w.
// The product's precision follows the operand type, as the JAX kernel's
// (_dot_precision, :41-52):
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
// What bounds it on an H100.  A tall x streams past a small iterate: at
// the streamed block (M 65,536, K 168, N 110) x and out are 73 MB in f32,
// 0.022 ms at 3.35 TB/s, against 3 x 2 M K N = 7.3 G TF32 operations,
// 0.015 ms at 495 TFLOP/s; with bf16 operands 51 MB, 0.015 ms, against 2.4
// G bf16 operations, 0.002 ms.  Bytes bound both, so the design streams x
// once, keeps w out of the stream and keeps x's loads in flight beside the
// MMAs:
//
// - Persistent CTAs, about one an SM (the wrapper sizes the grid from the
//   occupancy query), in columns of BN = 112 output columns (N 110 padded
//   to the next valid wgmma width, not to 128).  A CTA loads its column of w
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
//   of each chunk (4 k-steps) start from zero and their sum is added into
//   f32 accumulators rounded to nearest (chained over a tile instead, out
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
// Shared-memory budget (227 KB a CTA): the ring takes 4 x 16 KB = 64 KB and
// the staged rows of out 14 KB; w takes K x 112 x 8 bytes for f32 (hi and
// lo planes: 150.5 KB at K 168) and K x 112 x 2 for bf16 (37.6 KB), K padded
// with zeros to the MMA's depth (8 tf32, 16 bf16) in shared memory only.
// So w is resident for K <= 168 (f32) or 672 (bf16); past that it is
// walked in panels of 160 or 640 rows of K, restaged once a tile and panel
// (from L2: w is small).  N > 112 takes more CTA columns.
//
// Tile table (each choice and what decided it on an H100; it stands in for
// the TPU tile sweep of the nearest product, scripts/kernel_tune.py:218-225):
//
//   rows a tile       128   two m64 warpgroups; 512 tiles of the streamed
//                           block over 132 SMs fill 97% of 4 rounds
//   columns a CTA     112   N 110 -> one n112 MMA, 2% padding (n128: 14%)
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
// Ranges: any M, K and N; x row-major and contiguous, w row-major.

#include <cuda.h>

#include <atomic>

#include "row_share_atb_tc.cuh"

namespace {

using atb_tc::bf16;
using atb_tc::smem_u32;

constexpr int THREADS = 256;
constexpr int BM = 128;                        // rows of x a tile
constexpr int BN = 112;                        // columns of out a CTA
constexpr int NACC = BN / 2;                   // f32 accumulators a thread: 56
constexpr int STAGES = 4;                      // x chunks in the ring
constexpr int CHUNK_ROW = 128;                 // bytes of a chunk's row: the swizzle's
constexpr int STAGE_BYTES = BM * CHUNK_ROW;    // 16 KB
constexpr int SMEM_CAP = 232448;               // shared memory of one CTA
constexpr int ALIGN = 1024;                    // the 128-byte swizzle's period
constexpr int BAR_BYTES = STAGES * 8;
constexpr int OUT_ROWS = 32;                   // rows of a tile staged at once for the stores
constexpr int OUT_BYTES = OUT_ROWS * BN * 4;   // 14 KB
constexpr int FREE = SMEM_CAP - ALIGN - STAGES * STAGE_BYTES - BAR_BYTES - OUT_BYTES;  // for w

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int KC = CHUNK_ROW / 4;   // columns of K a chunk
  static constexpr int KSTEP = 8;            // K of one MMA
  static constexpr int ROW_BYTES = 8 * BN;   // a row of K in the hi and lo planes
  static constexpr int PANEL = 160;          // rows of K a panel, where K does not fit
};
template <>
struct Cfg<bf16> {
  static constexpr int KC = CHUNK_ROW / 2;
  static constexpr int KSTEP = 16;
  static constexpr int ROW_BYTES = 2 * BN;
  static constexpr int PANEL = 640;
};

// Deepest K of w resident at once, a multiple of the MMA's depth.
template <typename T>
constexpr int kmax() {
  return FREE / Cfg<T>::ROW_BYTES / Cfg<T>::KSTEP * Cfg<T>::KSTEP;
}
static_assert(kmax<float>() == 168 && kmax<bf16>() == 672, "the budget in the note");
static_assert(Cfg<float>::PANEL % Cfg<float>::KC == 0 && Cfg<float>::PANEL <= kmax<float>() &&
                  Cfg<bf16>::PANEL % Cfg<bf16>::KC == 0 && Cfg<bf16>::PANEL <= kmax<bf16>(),
              "a panel is whole chunks and fits");

// Rows of K of w a CTA holds: all of K, padded to the MMA's depth, where it
// fits; else a panel.
template <typename T>
int panel_rows(int k) {
  constexpr int S = Cfg<T>::KSTEP;
  const int padded = (k + S - 1) / S * S;
  return padded <= kmax<T>() ? padded : Cfg<T>::PANEL;
}

template <typename T>
constexpr int smem_bytes(int rows) {
  return ALIGN + STAGES * STAGE_BYTES + rows * Cfg<T>::ROW_BYTES + BAR_BYTES + OUT_BYTES;
}

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
__device__ __forceinline__ void wgmma_tf32(float (&d)[NACC], const uint32_t (&a)[4], uint64_t desc,
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
__device__ __forceinline__ void wgmma_bf16(float (&d)[NACC], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Registers that an in-flight wgmma reads or writes (atb_tc::hold, at
// these widths).
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
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

// T: the operands' type.  TMA: x's rows and base are 16-byte aligned, and
// its chunks come by TMA; else element by element.
template <typename T, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
    matmul_tc(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ x,
              const T* __restrict__ w, void* __restrict__ out, int out_bf16, long long m, int k,
              int n, int kw) {
  using C = Cfg<T>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int STEPS = C::KC / C::KSTEP;  // MMA k-steps a chunk: 4
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  unsigned char* planes = ring + STAGES * STAGE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(planes + kw * C::ROW_BYTES);
  float* staged = reinterpret_cast<float*>(bars + STAGES);  // OUT_ROWS x BN sums

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
    const int s = (int)(j % STAGES);
    const uint32_t bar = smem_u32(bars + s);
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load(smem_u32(ring + s * STAGE_BYTES), &xmap, (int)(j - it * cpt) * C::KC,
             (int)((blockIdx.x + it * gridDim.x) * BM), bar);
  };
  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(bars + s));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < STAGES && s < jobs; ++s) issue(s);
    }
  }  // the barrier before the first stage_w orders the inits before any wait

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
  const uint32_t plane_hi = smem_u32(planes);
  const uint32_t plane_lo = plane_hi + kw * BN * 4;  // f32 only
  int ci = 0;        // chunk of the current tile
  long long it = 0;  // tiles done
  for (long long j = 0; j < jobs; ++j) {
    const int col0 = ci * C::KC;
    const long long row0 = (blockIdx.x + it * gridDim.x) * BM;
    const int kp0 = paneled ? col0 / kw * kw : 0;
    if (j == 0 || (paneled && col0 == kp0)) {
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
    const int kk0 = (col0 - kp0) / C::KSTEP;  // the chunk's first k-step in the planes
    if constexpr (F32) {
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
          wgmma_tf32(d, al[q], smem_desc(plane_hi + off, 128, sbo), q == 0 ? 0 : 1);
          wgmma_tf32(d, ah[q], smem_desc(plane_lo + off, 128, sbo), 1);
        }
      }
#pragma unroll
      for (int q = 0; q < STEPS; ++q) {
        if (q < steps) {
          wgmma_tf32(d, ah[q], smem_desc(plane_hi + (kk0 + q) * 256, 128, sbo), 1);
        }
      }
      atb_tc::wgmma_commit();
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
    // the chunk's MMAs started from zero: their sum into acc, rounded to nearest
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += d[i];
    if (++ci == cpt) {  // the tile's last chunk: store it
      // Through shared memory, OUT_ROWS rows at a time (the rows of warps
      // 2 h and 2 h + 1), so that a warp's stores are 128 contiguous bytes
      // of out, not 32 bytes of each of 8 rows: accumulator 4 jn + q is row
      // g (+8 for q >= 2), column 8 jn + 2 t + (q & 1) of the warp's 16.
      const int rows = (int)min((long long)BM, m - row0);
      const int cols = min(BN, n - n0);
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
            const float val = staged[r * BN + c];
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
}

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
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
// launch, where the call is host time beside a ~0.04 ms kernel.
template <typename T, bool TMA>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ULL << dev;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(matmul_tc<T, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<T>(kmax<T>()));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, bool TMA>
cudaError_t launch(const void* x, const void* w, void* out, long long m, int k, int n, int out_bf16,
                   int ctas, cudaStream_t stream) {
  CUtensorMap map{};
  if constexpr (TMA) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
    const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(T)};
    const cuuint32_t box[2] = {(cuuint32_t)Cfg<T>::KC, (cuuint32_t)BM};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(
        &map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
        const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem<T, TMA>();
  if (err != cudaSuccess) return err;
  const long long row_tiles = (m + BM - 1) / BM;
  const int col_tiles = (n + BN - 1) / BN;
  if (col_tiles > 65535) return cudaErrorInvalidValue;
  const long long per_col = ctas / col_tiles > 1 ? ctas / col_tiles : 1;
  const dim3 grid((unsigned)(row_tiles < per_col ? row_tiles : per_col), (unsigned)col_tiles);
  const int kw = panel_rows<T>(k);
  matmul_tc<T, TMA><<<grid, THREADS, smem_bytes<T>(kw), stream>>>(
      map, static_cast<const T*>(x), static_cast<const T*>(w), out, out_bf16, m, k, n, kw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* out, long long m, int k, int n,
                     int out_bf16, int ctas, cudaStream_t s) {
  // TMA: a 16-byte aligned base and row stride
  const bool tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (k * sizeof(T)) % 16 == 0;
  return tma ? launch<T, true>(x, w, out, m, k, n, out_bf16, ctas, s)
             : launch<T, false>(x, w, out, m, k, n, out_bf16, ctas, s);
}

}  // namespace

// CTAs of the kernel that fit one SM at once at depth k, into *out.
extern "C" int matmul_ctas_per_sm(int x_bf16, int k, int* out) {
  const cudaError_t err = x_bf16 ? allow_smem<bf16, true>() : allow_smem<float, true>();
  if (err != cudaSuccess) return (int)err;
  const auto kernel = x_bf16 ? (const void*)matmul_tc<bf16, true> : (const void*)matmul_tc<float, true>;
  const int smem = x_bf16 ? smem_bytes<bf16>(panel_rows<bf16>(k)) : smem_bytes<float>(panel_rows<float>(k));
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, THREADS, smem);
}

// out (m x n, f32 or bf16) = x (m x k) @ w (k x n), both row-major and of
// one dtype (f32, or bf16 when x_bf16), on at most `ctas` CTAs (the card's
// resident ones).  Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int matmul_launch(const void* x, const void* w, void* out, long long m, int k, int n,
                             int x_bf16, int out_bf16, int ctas, void* stream) {
  if (m < 1 || k < 1 || n < 1 || ctas < 1 || m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? dispatch<bf16>(x, w, out, m, k, n, out_bf16, ctas, s)
                      : dispatch<float>(x, w, out, m, k, n, out_bf16, ctas, s));
}
