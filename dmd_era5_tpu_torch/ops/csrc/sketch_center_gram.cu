// K2 on Hopper: the centred sketch, row statistics and Gram matrix of the
// two-pass fallback.
//
// Replaces two Pallas kernels of dmd_era5_tpu/ops/matmul.py behind
// sketch_center_gram(), which compute one function:
//
//   K2a  _sketch_center_gram_kernel_1k  the whole time axis in one block
//   K2b  _sketch_center_gram_kernel     T tiled by block_k, f32 accumulator
//
// The split by whether T fits one VMEM block is a TPU artifact; here one
// kernel walks T in chunks for every T.  From X (M x T) and a sketch W
// (T x N):
//
//   y   = X W                                  f32 accumulation
//   rs  = sum_t x,  ss = sum_t x*x             from the f32 values of X
//   Yc  = round_out(y - (rs * inv_t) colsum(W))  stored in the out dtype
//   G   = Yc^T Yc                              from the STORED Yc
//
// Stage 1 (scg_sketch): a CTA owns a 128-row tile of X and 128 columns of
// the sketch, and walks T in 32-step chunks staged through shared memory
// (X transposed, W as is), 8 x 8 outputs per thread in f32 registers.  The
// first 128 threads also sum each row of the chunk, so every CTA has the
// row sums it centres with; the CTAs of the first column block store the
// (M, 2) statistics.  The epilogue centres, rounds to the out dtype and
// stores Yc.  Neighbouring CTAs are the column blocks of one row tile, so
// X is re-read from L2, not HBM.
//
// Stage 2 (G from the stored Yc): the row-share reduction of
// row_share_atb.cuh over the upper 64 x 64 blocks of Yc^T Yc: f32 per
// 128-row tile, f64 across a CTA's rows in registers, one fixed-order
// reduction over the shares, mirrored to an exactly symmetric G.  K1
// (sketch_center_gram_project.cu) instead adds each tile's G into f64
// partials in device memory, about 80 bytes of traffic per element of X
// at T = 168; holding the sums in registers costs one re-read of the
// stored Yc (M N elements, under 3% of X's at T = 8,760).
//
// What bounds it on an H100: 2 M T N + M N^2 flops against (M T + T N + M N)
// element reads and writes.  At the hourly year (M 977,400, T 8,760,
// N 256, f32) that is about 4.45e12 flops against 35 GB, so a kernel on the
// f32 CUDA cores (67 TFLOP/s) is bound by arithmetic (~66 ms), not HBM.
// This first version is plain shared-memory tiling in full f32 FMAs (the
// JAX package's HIGHEST; bf16 operands are upcast, their products exact in
// f32), with no load/compute overlap.  Tensor cores, TMA and pipelining are
// later work.
//
// Ranges: any M and T; N up to the wrapper's limit (the Gram scratch,
// n_share * N^2 doubles); ragged rows, time steps and columns masked.

#include "row_share_atb.cuh"

namespace {

using bf16 = __nv_bfloat16;
using atb::to_f32;

constexpr int THREADS = 256;
constexpr int BM = 128;  // rows of X per CTA
constexpr int BN = 128;  // sketch columns per CTA
constexpr int KT = 32;   // time steps per chunk
constexpr int XS = BM + 4;  // row stride of the transposed X chunk (float4-aligned)

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Params {
  const void* x;
  const void* w;
  const float* colw;
  void* yc;
  float* stats;
  long long m;
  int t;
  int n;
  float inv_t;
};

template <typename TX, typename TY>
__global__ void __launch_bounds__(THREADS) scg_sketch(Params p) {
  __shared__ __align__(16) float xs[KT][XS];  // X chunk, transposed: xs[k][row]
  __shared__ __align__(16) float ws[KT][BN];  // W chunk
  __shared__ float rs_s[BM];

  const TX* __restrict__ x = static_cast<const TX*>(p.x);
  const TX* __restrict__ w = static_cast<const TX*>(p.w);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*8 .. ty*8+7 of the tile
  const int tx = tid % 16;  // columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int lane = tid % 32;
  const int lrow = tid / 32;
  const long long m = p.m;
  const int t_len = p.t;
  const int n = p.n;
  const int n_cb = (n + BN - 1) / BN;
  const int cb = blockIdx.x % n_cb;
  const long long r0 = (long long)(blockIdx.x / n_cb) * BM;
  const int c0 = cb * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float rs_run = 0.f;  // thread tid < BM: row tid of the tile
  float ss_run = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += KT) {
    // X chunk: a warp reads 32 neighbouring time steps of one row
#pragma unroll 4
    for (int q = 0; q < BM / (THREADS / 32); ++q) {
      const int row = lrow + (THREADS / 32) * q;
      const long long gr = r0 + row;
      const int gt = t0 + lane;
      xs[lane][row] = (gr < m && gt < t_len) ? to_f32(x[gr * t_len + gt]) : 0.f;
    }
    // W chunk: a warp reads 32 neighbouring columns of one time step
#pragma unroll 4
    for (int e = tid; e < KT * BN; e += THREADS) {
      const int k = e / BN;
      const int col = e % BN;
      const int gt = t0 + k;
      ws[k][col] = (gt < t_len && c0 + col < n) ? to_f32(w[(size_t)gt * n + c0 + col]) : 0.f;
    }
    __syncthreads();
    if (tid < BM) {  // the chunk's share of row tid's statistics
      float a = 0.f;
      float b = 0.f;
#pragma unroll 8
      for (int k = 0; k < KT; ++k) {
        const float v = xs[k][tid];
        a += v;
        b = fmaf(v, v, b);
      }
      rs_run += a;
      ss_run += b;
    }
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < BM) {
    rs_s[tid] = rs_run;
    const long long gr = r0 + tid;
    if (cb == 0 && gr < m) {
      p.stats[gr * 2] = rs_run;
      p.stats[gr * 2 + 1] = ss_run;
    }
  }
  __syncthreads();

  // epilogue: centre, round to the storage dtype, store Yc
  TY* __restrict__ yc = static_cast<TY*>(p.yc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ty * 8 + i;
    const long long gr = r0 + row;
    if (gr >= m) continue;
    const float mu = rs_s[row] * p.inv_t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < n) {
        const float v = round_to<TY>(acc[i][j] - __fmul_rn(mu, p.colw[col]));
        yc[gr * n + col] = from_f32<TY>(v);
      }
    }
  }
}

struct Launch {
  const Params& p;
  double* g_part;
  float* g;
  int n_share;
  cudaStream_t stream;
  template <typename TX, typename TY>
  cudaError_t run() const {
    const long long n_tiles = (p.m + BM - 1) / BM;
    const long long blocks = n_tiles * ((p.n + BN - 1) / BN);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    scg_sketch<TX, TY><<<(unsigned)blocks, THREADS, 0, stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const TY* yc = static_cast<const TY*>(p.yc);
    return atb::launch<TY>(yc, yc, g_part, g, p.m, p.n, p.n, 1, n_share, stream);
  }
};

}  // namespace

// CTAs of the Gram stage's main kernel that fit one SM at once, into *out.
extern "C" int scg_gram_ctas_per_sm(int out_bf16, int* out) {
  return (int)(out_bf16 ? atb::ctas_per_sm<__nv_bfloat16>(out) : atb::ctas_per_sm<float>(out));
}

// Yc (m x n, out dtype), stats (m x 2, f32: row sum, row sum of squares)
// and G (n x n, f32); g_part holds n_share * n * n doubles.  Returns a
// cudaError_t code: 0 when every kernel was launched.
extern "C" int scg_launch(const void* x, const void* w, const float* colw, void* yc,
                          float* stats, double* g_part, float* g, long long m, int t,
                          int n, int x_bf16, int out_bf16, float inv_t, int n_share,
                          void* stream) {
  if (m < 1 || t < 1 || n < 1 || n_share < 1) return (int)cudaErrorInvalidValue;
  const Params p{x, w, colw, yc, stats, m, t, n, inv_t};
  const Launch op{p, g_part, g, n_share, static_cast<cudaStream_t>(stream)};
  return (int)atb::dispatch(op, x_bf16, out_bf16);
}
