// K6 on Hopper: the tiled matmul out = x @ w, summed in f32.
//
// Replaces the Pallas kernel dmd_era5_tpu/ops/matmul.py::_matmul_kernel
// (behind matmul, :101), the per-block sketch of the out-of-core SVD
// (dmd_era5_tpu/pipeline/streamed_fit.py:166-185): each streamed row block
// X_blk (65,536 x 168 at ERA5-week size) times the (168 x 110) iterate.
//
//   f32 x f32 -> f32 with full-f32 FMAs (the JAX package's HIGHEST; no TF32)
//   bf16 x bf16 -> f32: each product of two bf16 values is exact in f32 (the
//                       Pallas DEFAULT bf16 pass), summed in f32
//
// The Pallas grid walks K in order and sums into one VMEM accumulator.
// Here a CTA owns one 64 x 128 tile of the output and walks K itself in
// 16-deep stages: the x tile is staged transposed in shared memory (padded
// so the transposing stores are free of bank conflicts), the w tile as is,
// and each of 256 threads keeps a 4 x 8 block of the output in registers,
// summed in f32 in ascending k.  Ragged M, N and K are masked in-kernel
// (zero operands add nothing), so the JAX entry's divisibility by its
// blocks, a TPU tiling constraint, does not carry over and the ragged last
// block of a pass takes this kernel too.
//
// What bounds it on an H100: 2 M K N flops against the bytes of x, w and
// out.  At the streamed block (M 65,536, K 168, N 110) in f32 that is 2.42
// GFLOP against 73 MB: 0.036 ms at the 67 TFLOP/s f32 peak, above the
// 0.022 ms the bytes take at 3.35 TB/s, so arithmetic bounds it; with bf16
// operands (51 MB) the bytes bound it at 0.015 ms.  This first version is a
// plain shared-memory tiled kernel on CUDA cores: no tensor cores, no TMA
// pipeline, loads not overlapped with FMAs, and N 110 padded to one
// 128-wide tile.  Its time is small next to the streamed pass it sits in,
// which the host-to-card copy of the block bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64;            // output rows per CTA
constexpr int BN = 128;           // output columns per CTA
constexpr int BK = 16;            // depth of one shared-memory stage
constexpr int XS_PITCH = BM + 2;  // 2 c + r spans all 32 banks on the stores

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// T: operand storage type; TO: output type.  Thread (ty, tx) owns output
// rows ty*4 .. ty*4+3 and columns tx*8 .. tx*8+7 of the CTA's tile.
template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  TO* __restrict__ out, long long m, int k, int n) {
  __shared__ float xs[BK][XS_PITCH];          // x tile transposed: [kk][row]
  __shared__ __align__(16) float ws[BK][BN];  // w tile: [kk][col]

  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // neighbouring threads read neighbouring k of one row of x
#pragma unroll
    for (int q = 0; q < BM * BK / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / BK;
      const int c = e % BK;
      const long long gr = row0 + r;
      const int gc = k0 + c;
      xs[c][r] = (gr < m && gc < k) ? to_f32(x[gr * k + gc]) : 0.f;
    }
    // ... and neighbouring columns of one row of w
#pragma unroll
    for (int q = 0; q < BK * BN / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const int gr = k0 + r;
      const int gc = col0 + c;
      ws[r][c] = (gr < k && gc < n) ? to_f32(w[(long long)gr * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][tx * 8 + 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gr = row0 + ty * 4 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + tx * 8 + j;
      if (gc < n) store(&out[gr * n + gc], acc[i][j]);
    }
  }
}

template <typename T, typename TO>
cudaError_t launch(const void* x, const void* w, void* out, long long m, int k,
                   int n, cudaStream_t stream) {
  const long long grid_x = (m + BM - 1) / BM;
  const int grid_y = (n + BN - 1) / BN;
  if (grid_x > 0x7fffffffLL || grid_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  matmul_kernel<T, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<TO*>(out),
      m, k, n);
  return cudaGetLastError();
}

}  // namespace

// out (m x n, f32 or bf16) = x (m x k) @ w (k x n), both row-major and of
// one dtype (f32, or bf16 when x_bf16).  Returns a cudaError_t code: 0 when
// the kernel was launched.
extern "C" int matmul_launch(const void* x, const void* w, void* out,
                             long long m, int k, int n, int x_bf16,
                             int out_bf16, void* stream) {
  if (m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16) {
    err = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, m, k, n, s)
                   : launch<__nv_bfloat16, float>(x, w, out, m, k, n, s);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(x, w, out, m, k, n, s)
                   : launch<float, float>(x, w, out, m, k, n, s);
  }
  return (int)err;
}
