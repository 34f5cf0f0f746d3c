// K7 on Hopper: Householder QR of one tall panel A (m x n), n <= 256.
//
// Replaces the Pallas kernel dmd_era5_tpu/ops/qr_panel.py::
// _householder_kernel (behind householder_panel, :290), the backward-stable
// TSQR leaf (dmd_era5_tpu/ops/tsqr.py:91-98) that re-orthonormalises the
// (T x r) iterate of the streamed randomized SVD between its passes.  It
// computes what the Pallas kernel computes, column by column j:
//
//   sigma = |A[j:, j]|^2;  sign = +1 where a_jj >= 0, else -1;
//   alpha = -sign sqrt(sigma);  v = A[j:, j] - alpha e_j;
//   beta = 2 / v^T v, or 0 where v^T v = 0;
//   A[j:, j:] -= v (beta v^T A[j:, j:])      (columns >= j only)
//
// then R = the upper triangle of A's first n rows, and Q = the reflectors
// applied in reverse to the first n columns of the identity.  The
// diag(R) >= 0 sign fix is left to the caller, as the JAX package applies
// it outside pallas_call.
//
// The Pallas kernel keeps the panel resident in VMEM.  Its envelope
// (3 m n 4 bytes <= 12 MiB: up to 1,048,576 floats, e.g. 8,760 x 110 or
// 4,096 x 256) is far past the 227 KB of shared memory of one CTA, so here
// one CTA of 1,024 threads factors the panel in device memory, where it
// stays L2-resident (4 MB at most): the working panel is the Q output
// buffer, the reflectors go to a (n x m) scratch, beta and the per-column
// partial sums to shared memory.  |A[j:, j]|^2 and v^T v are block
// reductions in a fixed order; v^T A over the trailing columns maps
// neighbouring threads to neighbouring columns of a row (coalesced), with
// the rows split over thread groups whose partials are summed in a fixed
// order.  Every sum is f32, as in the Pallas kernel.  The reverse pass for
// Q touches only columns >= j: the columns left of j are zero in rows >= j
// there, so their products with v are exactly zero in the Pallas kernel
// too.
//
// What bounds it on an H100: 4 m n^2 - 4 n^3 / 3 flops against 8 m n
// bytes -- at the slice's (168 x 110), 6.4 MFLOP, well under a microsecond
// at the 67 TFLOP/s f32 peak.  In practice one CTA walks 2 n dependent
// steps, each a few barriers and a pass over the trailing panel from L2,
// so latency bounds it.  At (168 x 110) the panel (74 KB) would fit shared
// memory; that, and a blocked (WY) form that turns the trailing updates
// into matrix products, are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int N_MAX = 256;

struct Shared {
  float2 red[WARPS];   // per-warp partials of a block reduction
  float part[THREADS]; // per-thread partials of v^T A
  float wcol[N_MAX];   // beta v^T A, per trailing column
  float beta[N_MAX];   // one per reflector
};

// (sum of a, sum of b) over the block, the same value in every thread.
__device__ float2 block_sum2(float a, float b, Shared& sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) sh.red[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  for (int w = 0; w < WARPS; ++w) {
    s.x += sh.red[w].x;
    s.y += sh.red[w].y;
  }
  __syncthreads();  // red is reused by the next reduction
  return s;
}

// work[j:, j:] -= v (beta v^T work[j:, j:]), v = vj[j:].  The trailing
// columns take `lanes` threads (a power of two >= n - j, at least a warp),
// the rows are split over THREADS / lanes groups.  Neither pointer is
// declared read-only: both are written earlier in the same launch.
__device__ void apply_reflector(float* work, const float* vj, float beta,
                                int m, int n, int j, Shared& sh) {
  const int cols = n - j;
  int lanes = 32;
  while (lanes < cols) lanes <<= 1;
  const int groups = THREADS / lanes;
  const int t = threadIdx.x;
  const int lc = t % lanes;
  const int grp = t / lanes;
  const int c = j + lc;

  float s = 0.f;
  if (lc < cols) {
    for (int i = j + grp; i < m; i += groups) {
      s = fmaf(vj[i], work[(size_t)i * n + c], s);
    }
  }
  sh.part[t] = s;
  __syncthreads();
  if (t < cols) {
    float tot = 0.f;
    for (int g = 0; g < groups; ++g) tot += sh.part[g * lanes + t];
    sh.wcol[t] = beta * tot;
  }
  __syncthreads();
  if (lc < cols) {
    const float wc = sh.wcol[lc];
    for (int i = j + grp; i < m; i += groups) {
      const size_t e = (size_t)i * n + c;
      work[e] = work[e] - vj[i] * wc;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
    householder_kernel(const float* __restrict__ a, float* q, float* r,
                       float* v, int m, int n) {
  __shared__ Shared sh;
  const int t = threadIdx.x;
  const size_t mn = (size_t)m * n;
  float* work = q;  // the working panel, then Q

  for (size_t e = t; e < mn; e += THREADS) work[e] = a[e];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    float all = 0.f;    // |A[j:, j]|^2
    float below = 0.f;  // |A[j+1:, j]|^2
    for (int i = j + t; i < m; i += THREADS) {
      const float x = work[(size_t)i * n + j];
      all = fmaf(x, x, all);
      if (i > j) below = fmaf(x, x, below);
    }
    const float2 s = block_sum2(all, below, sh);
    const float ajj = work[(size_t)j * n + j];
    const float sign = ajj >= 0.f ? 1.f : -1.f;
    const float alpha = -sign * sqrtf(s.x);
    const float vjj = ajj - alpha;
    const float vtv = s.y + vjj * vjj;
    const float beta = vtv > 0.f ? 2.f / vtv : 0.f;
    float* vj = v + (size_t)j * m;
    for (int i = j + t; i < m; i += THREADS) {
      vj[i] = (i == j) ? vjj : work[(size_t)i * n + j];
    }
    if (t == 0) sh.beta[j] = beta;
    __syncthreads();
    apply_reflector(work, vj, beta, m, n, j, sh);
  }

  for (int e = t; e < n * n; e += THREADS) {
    const int row = e / n;
    const int col = e % n;
    r[e] = row <= col ? work[(size_t)row * n + col] : 0.f;
  }
  __syncthreads();
  for (size_t e = t; e < mn; e += THREADS) {
    work[e] = (e / n == e % n) ? 1.f : 0.f;
  }
  __syncthreads();
  for (int j = n - 1; j >= 0; --j) {
    apply_reflector(work, v + (size_t)j * m, sh.beta[j], m, n, j, sh);
  }
}

}  // namespace

// Q (m x n) and R (n x n) of a row-major f32 panel a (m x n), m >= n,
// 1 <= n <= 256; v is (n x m) f32 scratch.  R's diagonal keeps the sign the
// reflectors give it.  Returns a cudaError_t code: 0 when the kernel was
// launched.
extern "C" int householder_launch(const float* a, float* q, float* r, float* v,
                                  int m, int n, void* stream) {
  if (n < 1 || n > N_MAX || m < n) return (int)cudaErrorInvalidValue;
  householder_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, q, r, v, m, n);
  return (int)cudaGetLastError();
}
