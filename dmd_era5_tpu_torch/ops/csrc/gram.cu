// K4 and K5 on Hopper: the Gram matrix G = A^T A of a tall panel A (M x K).
//
// Replaces two Pallas kernels of dmd_era5_tpu/ops/qr_panel.py behind gram():
//
//   K4  _gram_kernel        full-f32 products (Precision.HIGHEST); A is f32
//                           or bf16 (bf16 values are exact in f32)
//   K5  _gram_split_kernel  A f32 split as H = bf16(A), L = bf16(A - H);
//                           G ~= H^T H + H^T L + (H^T L)^T (L^T L dropped)
//
// The Pallas grid runs in order and sums G into one resident block.  Here
// the work is split two ways: a CTA owns one upper block (bi <= bj) of G (G
// is symmetric, so the blocks below the diagonal are never computed) and
// one share of the rows of A, which it walks in 128-row tiles (grid-stride
// over tiles).  Each tile's contribution is summed in f32 from zero and then
// added into an f64 sum, as in K1 (sketch_center_gram_project.cu): an f32
// running sum over the ~118k rows a CTA sees at ERA5-week size makes G
// indefinite in its noise directions.  Each CTA writes its f64 block once;
// a second kernel sums the row shares in a fixed order and mirrors the
// upper triangle into the lower one.  No atomics: G is identical from run
// to run and exactly symmetric.
//
// K4 (gram_main below): 64 x 64 blocks on CUDA cores, full-f32 FMAs, 4 x 4
// outputs a thread with its f64 sums in registers, 32-row chunks of the two
// 64-column slices of A staged in shared memory.  At K = 168 the symmetric
// half is M K (K+1) flops against 4 M K bytes, ~42 flops per byte: bound
// by arithmetic on the f32 CUDA cores (67 TFLOP/s).  Tensor cores (3xTF32)
// are later work.
//
// K5 (the bf16 split) runs on the tensor-core mainloop of
// row_share_atb_tc.cuh (atb_split_bf16, mma.sync on a cp.async ring) with
// `upper`: H and L are formed in registers once
// per element a warp loads, and each upper block takes three bf16 MMAs,
// H_i^T H_j + H_i^T L_j + L_i^T H_j, into one f32 accumulator; their sum over
// the blocks is H^T H + H^T L + (H^T L)^T.  A bf16 x bf16 product is exact in
// f32.  What bounds it on an H100: 3 M K^2 bf16 operations (the upper half
// of three products) at 989 TFLOP/s against 4 M K bytes at 3.35 TB/s; at
// K 110 and 168 the bytes (~3 bf16 operations per byte of A), at the year's
// K 8,760 the operations (2.25e14, 228 ms).  Block edge by K (the table
// that replaces the TPU tile sweep of scripts/kernel_tune.py):
//
//   K <= 256   64 x 64    K 110: 3 blocks, 2.0x the upper half's entries;
//                         K 168: 6 blocks, 1.7x (128-wide blocks: 2.7x and
//                         3.5x for the same L2 traffic, 3 KB a row at 168)
//   K > 256    128 x 128  four times the MMAs per staged byte; at K 8,760
//                         2,415 blocks, 1.03x; a CTA row of blocks shares
//                         its A slice from L2
//
// Ranges: any K (the JAX kernel stops at 1024, where its K x K accumulator
// no longer fits VMEM).  The f64 scratch in device memory is
// n_share * n_pairs * 64 * 64 doubles for K4 and n_share * K * K for K5.
// The ragged last tile and the columns past K are masked in-kernel (zero
// rows and columns add nothing), so A is never padded or copied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_share_atb_tc.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int OB = 64;           // edge of an output block of G
constexpr int KC = 32;           // rows of A per shared-memory chunk
constexpr int MT = 128;          // rows of A per tile: summed in f32 from zero
constexpr int CHUNKS = MT / KC;  // chunks per tile
constexpr int LOAD_ROWS = THREADS / OB;  // rows staged per pass of the CTA

struct Params {
  const void* a;
  double* part;  // [n_split][n_pairs][OB][OB] per-CTA f64 sums
  long long m;
  int k;
  int nb;       // blocks of OB columns: ceil(K / OB)
  int n_pairs;  // upper blocks: nb (nb + 1) / 2
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Upper block pairs in row-major order: (0,0), (0,1), ..., (0,nb-1), (1,1), ...
__host__ __device__ __forceinline__ int pair_index(int bi, int bj, int nb) {
  return bi * nb - bi * (bi - 1) / 2 + (bj - bi);
}

__device__ __forceinline__ void pair_blocks(int p, int nb, int& bi, int& bj) {
  bi = 0;
  while (p >= nb - bi) {
    p -= nb - bi;
    ++bi;
  }
  bj = bi + p;
}

// K4.  TA: storage type of A.  Thread (ty, tx) owns rows ty*4.. of the
// block's left slice and columns tx*4.. of its right slice.
template <typename TA>
__global__ void __launch_bounds__(THREADS) gram_main(Params p) {
  __shared__ __align__(16) float as[KC][OB];
  __shared__ __align__(16) float bs[KC][OB];

  const int pair = blockIdx.x % p.n_pairs;
  const int share = blockIdx.x / p.n_pairs;
  const int n_share = gridDim.x / p.n_pairs;
  int bi, bj;
  pair_blocks(pair, p.nb, bi, bj);

  const TA* __restrict__ a = static_cast<const TA*>(p.a);
  const long long m = p.m;
  const int k = p.k;
  const long long n_tiles = (m + MT - 1) / MT;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int lc = tid % OB;  // staging: this thread's column of each slice
  const int lr = tid / OB;  // ... and its first row
  const int ca = bi * OB + lc;
  const int cb = bj * OB + lc;

  double accd[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accd[i][j] = 0.0;

  for (long long tile = share; tile < n_tiles; tile += n_share) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c = 0; c < CHUNKS; ++c) {
      const long long r0 = tile * MT + c * KC;
#pragma unroll
      for (int q = 0; q < KC / LOAD_ROWS; ++q) {
        const int row = lr + LOAD_ROWS * q;
        const long long gr = r0 + row;
        const float va = (gr < m && ca < k) ? to_f32(a[gr * k + ca]) : 0.f;
        const float vb = (gr < m && cb < k) ? to_f32(a[gr * k + cb]) : 0.f;
        as[row][lc] = va;
        bs[row][lc] = vb;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < KC; ++r) {
        const float4 a4 = *reinterpret_cast<const float4*>(&as[r][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&bs[r][tx * 4]);
        const float ah[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bh[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ah[i], bh[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) accd[i][j] += acc[i][j];
  }

  double* dst = p.part + ((size_t)share * p.n_pairs + pair) * OB * OB;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[(ty * 4 + i) * OB + tx * 4 + j] = accd[i][j];
}

// G[i][j] = sum over row shares, in share order, of the upper block entry
// (min(i,j), max(i,j)): deterministic, and G == G^T bit for bit.
__global__ void gram_reduce(const double* __restrict__ part, float* g, int k,
                            int nb, int n_pairs, int n_share) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)k * k) return;
  int i = (int)(idx / k);
  int j = (int)(idx % k);
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  const size_t off = (size_t)pair_index(i / OB, j / OB, nb) * OB * OB +
                     (i % OB) * OB + (j % OB);
  const size_t stride = (size_t)n_pairs * OB * OB;
  double s = 0.0;
  for (int sh = 0; sh < n_share; ++sh) s += part[sh * stride + off];
  g[idx] = (float)s;
}

template <typename TA>
cudaError_t launch_main(const Params& p, int n_cta, cudaStream_t stream) {
  gram_main<TA><<<n_cta, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K5's block edge at width k (the table above).
extern "C" int gram_split_block_edge(int k) { return k <= 256 ? 64 : 128; }

// CTAs of the main kernel that fit one SM at once, into *ctas_per_sm: K4
// (split 0) for f32 or bf16 A, or K5 (split 1) at width k.  Returns a
// cudaError_t code.
extern "C" int gram_ctas_per_sm(int a_bf16, int split, int k, int* ctas_per_sm) {
  if (a_bf16 && split) return (int)cudaErrorInvalidValue;
  if (split) {
    return (int)atb_tc::ctas_per_sm(
        gram_split_block_edge(k) == 64 ? atb_tc::split_main<64>() : atb_tc::split_main<128>(),
        ctas_per_sm);
  }
  if (a_bf16) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, gram_main<__nv_bfloat16>, THREADS, 0);
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, gram_main<float>,
                                                            THREADS, 0);
}

// G (k x k, f32) of a (m x k, row-major, f32 or bf16) over n_share row
// shares.  part holds n_share * n_pairs * 64 * 64 doubles of scratch for K4
// and n_share * k * k for K5.  Returns a cudaError_t code: 0 when both
// kernels were launched.
extern "C" int gram_launch(const void* a, double* part, float* g, long long m,
                           int k, int a_bf16, int split, int n_share,
                           void* stream) {
  if (m < 1 || k < 1 || n_share < 1 || (a_bf16 && split)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split) {
    const float* af = static_cast<const float*>(a);
    return (int)atb_tc::launch(
        gram_split_block_edge(k) == 64 ? atb_tc::split_main<64>() : atb_tc::split_main<128>(),
        af, af, part, g, m, k, k, 1, n_share, s);
  }
  const int nb = (k + OB - 1) / OB;
  const int n_pairs = nb * (nb + 1) / 2;
  const long long n_cta = (long long)n_share * n_pairs;
  if (n_cta > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Params p{a, part, m, k, nb, n_pairs};
  cudaError_t err = a_bf16 ? launch_main<__nv_bfloat16>(p, (int)n_cta, s)
                           : launch_main<float>(p, (int)n_cta, s);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)k * k;
  const int blocks = (int)((total + THREADS - 1) / THREADS);
  gram_reduce<<<blocks, THREADS, 0, s>>>(part, g, k, nb, n_pairs, n_share);
  return (int)cudaGetLastError();
}
