// C = A^T B over the rows of two tall matrices, f64-grade, on the CUDA
// cores: the reduction of K2's Gram stage (G = Yc^T Yc,
// sketch_center_gram.cu).  Its scratch layout, fixed-order reduction
// (atb_reduce) and dtype dispatch are shared with the tensor-core mainloop
// of K3 and K5 (row_share_atb_tc.cuh).
//
// A is M x NA and B is M x NB, both row-major, both f32 or both bf16 (bf16
// values are exact in f32).  A CTA owns one 64 x 64 block (bi, bj) of C and
// one share of the rows, which it walks in 128-row tiles (grid-stride over
// tiles by the number of shares).  Each tile's contribution is summed in
// f32 from zero and then added into f64 sums held in registers, as in K4
// (gram.cu): an f32 running sum over a CTA's rows loses the noise-floor
// directions of a Gram matrix at ERA5 size.  Each CTA writes its f64 block
// once into its share's slice of the scratch; a second kernel sums the
// shares in a fixed order.  No atomics: C is identical from run to run.
// With `upper` only the blocks bi <= bj of a symmetric product (A = B) are
// computed and the reduction mirrors the upper triangle, so G comes out
// exactly symmetric.
//
// Ranges: any M, NA and NB; the ragged last tile and the columns past NA
// and NB are masked in-kernel.  The wrapper sizes the scratch,
// n_share * NA * NB doubles, and caps n_share to keep it near 1 GiB.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace atb {

constexpr int THREADS = 256;
constexpr int OB = 64;  // edge of an output block
constexpr int KC = 32;  // rows per shared-memory chunk
constexpr int MT = 128;  // rows per tile: summed in f32 from zero

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    atb_main(const T* __restrict__ a, const T* __restrict__ b,
             double* __restrict__ part, long long m, int na, int nb,
             int upper, int n_share) {
  __shared__ __align__(16) float as[KC][OB];
  __shared__ __align__(16) float bs[KC][OB];
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int nbb = (nb + OB - 1) / OB;
  int bi, bj;
  if (upper) {  // pairs (0,0), (0,1), ..., (0,nbb-1), (1,1), ... in order
    int idx = blockIdx.x;
    bi = 0;
    while (idx >= nbb - bi) {
      idx -= nbb - bi;
      ++bi;
    }
    bj = bi + idx;
  } else {
    bi = blockIdx.x / nbb;
    bj = blockIdx.x % nbb;
  }
  const int a0 = bi * OB;
  const int b0 = bj * OB;
  const long long n_tiles = (m + MT - 1) / MT;

  double sum[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[i][j] = 0.0;

  for (long long tile = blockIdx.y; tile < n_tiles; tile += n_share) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < MT / KC; ++c) {
      const long long r0 = tile * MT + c * KC;
      // a warp stages 32 neighbouring columns of one row: coalesced
      for (int e = tid; e < KC * OB; e += THREADS) {
        const int k = e / OB;
        const int col = e % OB;
        const long long gr = r0 + k;
        const bool row_ok = gr < m;
        as[k][col] = (row_ok && a0 + col < na) ? to_f32(a[gr * na + a0 + col]) : 0.f;
        bs[k][col] = (row_ok && b0 + col < nb) ? to_f32(b[gr * nb + b0 + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = bs[k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[i][j] += (double)acc[i][j];
  }

  double* dst = part + (size_t)blockIdx.y * na * nb;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = a0 + ty * 4 + i;
      const int c = b0 + tx + 16 * j;
      if (r < na && c < nb) dst[(size_t)r * nb + c] = sum[i][j];
    }
}

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

inline int n_out_blocks(int na, int nb, int upper) {
  const int nba = (na + OB - 1) / OB;
  const int nbb = (nb + OB - 1) / OB;
  return upper ? nbb * (nbb + 1) / 2 : nba * nbb;
}

// Launches both kernels on `stream`; returns a cudaError_t code.
template <typename T>
cudaError_t launch(const T* a, const T* b, double* part, float* out, long long m,
                   int na, int nb, int upper, int n_share, cudaStream_t stream) {
  if (m < 1 || na < 1 || nb < 1 || n_share < 1 || n_share > 65535 ||
      (upper && na != nb)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(n_out_blocks(na, nb, upper), n_share);
  atb_main<T><<<grid, THREADS, 0, stream>>>(a, b, part, m, na, nb, upper, n_share);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)na * nb;
  atb_reduce<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      part, out, n_share, na, nb, upper);
  return cudaGetLastError();
}

// CTAs of atb_main<T> that fit one SM at once, into *out.
template <typename T>
cudaError_t ctas_per_sm(int* out) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, atb_main<T>, THREADS, 0);
}

// op.run<A, B>() with A and B each float or bf16, chosen by the two flags.
template <typename Op>
cudaError_t dispatch(const Op& op, int a_bf16, int b_bf16) {
  using bf16 = __nv_bfloat16;
  if (a_bf16 && b_bf16) return op.template run<bf16, bf16>();
  if (a_bf16) return op.template run<bf16, float>();
  if (b_bf16) return op.template run<float, bf16>();
  return op.template run<float, float>();
}

}  // namespace atb
