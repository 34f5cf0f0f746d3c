// K1 on Hopper: the fused sketch / centre / Gram / projection pass.
//
// Replaces dmd_era5_tpu/ops/matmul.py::_sketch_center_gram_project_kernel_1k
// (the Pallas kernel behind sketch_center_gram_project).  From one read of
// the snapshot matrix X (M x T) and a sketch W (T x N) it computes, per
// tile of 128 rows (two 64-row sub-tiles for the sketch product):
//
//   Y   = X W                          (f32 accumulation)
//   rs  = row sums of X  (or Y[:, N-1] when W's last column is all ones)
//   ss  = row sums of x*x (the square rounded to the storage dtype under
//         stats_col, as the Pallas kernel squares in the storage dtype)
//   Yc  = round_out(Y - (rs * inv_t) colsum(W))     stored in out dtype
//   G  += Yc^T Yc,  C += Yc^T X                     from the STORED Yc
//
// The Pallas grid runs in order and sums G and C into one resident block.
// Here CTAs run concurrently, so each CTA walks its own rows (grid-stride
// over row tiles) and keeps private partial G, C and scalar stats in
// device scratch; a second kernel sums the partials in a fixed order.
// No atomics: results are identical from run to run.
//
// Each 128-row tile's contribution is summed in f32 from zero, and the
// per-CTA partials accumulate those tile sums in f64.  An f32 running sum
// over a CTA's ~60k rows (one ERA5 week) loses the noise-floor directions
// of G: its rounding, ~1e-5 of |G|, exceeds their eigenvalues, so G comes
// out indefinite and the fit step's trailing components lose
// orthonormality (measured on an H100; cuBLAS's f32 product does the
// same).  G and C are still returned in f32.
//
// What bounds it on an H100: at T = 168 and N = 256 the three products do
// about 1.8k flops per element of X, and the algorithm needs about 10
// bytes per element (X read, Yc written), so a fused kernel is bound by
// f32 FMA throughput on CUDA cores, not by HBM.  This first version is a
// plain shared-memory tiled kernel in full f32 FMAs (no TF32), which
// matches Precision.HIGHEST of the JAX package; bf16 inputs are converted
// to f32, where bf16 x bf16 products are exact.  It also reads and writes
// its f64 partials once per tile, about 80 bytes per element of X at that
// shape, and runs one 256-thread CTA per SM (235 registers at N = 256):
// 12-19 TFLOP/s measured, 18-29% of the f32 peak (H100 80GB HBM3, 700 W).
// Tensor cores (bf16 wgmma, or 3xTF32 for f32), on-chip partials and TMA
// loads are left to later work.
//
// Ranges: N <= 256 (the Hankel sketch at d = 2, r = 128), any T (X is
// never held whole in shared memory; each tile is re-read from L2 for the
// projection), ragged M masked in-kernel.  The grid is one wave of the
// CTAs that fit the card at once (scgp_ctas_per_sm); the wrapper's f64
// partial scratch, n_cta * N * (N + T) * 8 bytes, is what grows with T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64;  // rows of X per sketch sub-tile
constexpr int MT = 2 * BM;  // rows of X per tile: one G/C partial update each
constexpr int KT = 16;  // time steps per chunk of the sketch product
constexpr int OT = 64;  // edge of an output tile of G or C
constexpr int XS = BM + 4;  // row stride of the transposed X chunk (fewer bank conflicts)

struct Params {
  const void* x;
  const void* w;
  const float* colw;
  void* yc;
  float* stats;
  double* g_part;
  double* c_part;
  double* st_part;
  long long m;
  int t;
  int n;
  int stats_col;
  int scalar_stats;
  int emit_yc;
  float inv_t;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr size_t smem_floats(int nt) {
  // ycs [MT][nt] + rs/ss [MT] each + max(phase-1 X/W chunks, phase-2 X tile)
  return (size_t)MT * nt + 2 * MT +
         ((KT * XS + KT * nt) > (MT * OT) ? (KT * XS + KT * nt) : (MT * OT));
}

// TX: storage type of X and W; TY: storage type of Yc; NT: N padded to
// a multiple of 64 (64, 128 or 256).
template <typename TX, typename TY, int NT>
__global__ void __launch_bounds__(THREADS)
    scgp_main(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ycs = smem;              // [MT][NT] stored Yc of the tile, as f32
  float* rs_s = ycs + MT * NT;    // [MT] row sums
  float* ss_s = rs_s + MT;        // [MT] row sums of squares
  float* xs = ss_s + MT;          // phase 1: [KT][XS] X chunk, transposed
  float* ws = xs + KT * XS;       // phase 1: [KT][NT] W chunk
  float* xs2 = ss_s + MT;         // phase 2: [MT][OT] X tile columns
  __shared__ double red[2][THREADS];

  const TX* __restrict__ x = static_cast<const TX*>(p.x);
  const TX* __restrict__ w = static_cast<const TX*>(p.w);
  TY* __restrict__ yc = static_cast<TY*>(p.yc);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long m = p.m;
  const int t_len = p.t;
  const int n = p.n;
  const long long n_tiles = (m + MT - 1) / MT;
  const int n_ot = (n + OT - 1) / OT;
  constexpr int NJ = NT / 16;

  double* gp = p.g_part + (size_t)blockIdx.x * n * n;
  double* cp = p.c_part + (size_t)blockIdx.x * n * t_len;
  double part_rs2 = 0.0;
  double part_ss = 0.0;
  bool first = true;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * MT;

    // ---- phase 1: Y = X W, row statistics on the way, per 64-row sub-tile
    for (int sub = 0; sub < MT / BM; ++sub) {
      const long long s0 = r0 + sub * BM;  // first row of the sub-tile
      float* ycs_s = ycs + sub * BM * NT;
      float* rs_ss = rs_s + sub * BM;
      float* ss_ss = ss_s + sub * BM;
      float acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      float rs_p[(BM * KT) / THREADS];
      float ss_p[(BM * KT) / THREADS];
#pragma unroll
      for (int q = 0; q < (BM * KT) / THREADS; ++q) rs_p[q] = ss_p[q] = 0.f;

      for (int t0 = 0; t0 < t_len; t0 += KT) {
        // X chunk: thread tid loads row ty + 16 q, time t0 + tx
#pragma unroll
        for (int q = 0; q < (BM * KT) / THREADS; ++q) {
          const int row = ty + 16 * q;
          const long long gr = s0 + row;
          const int gt = t0 + tx;
          float v = 0.f;
          if (gr < m && gt < t_len) {
            v = to_f32(x[gr * t_len + gt]);
            rs_p[q] += v;
            ss_p[q] += p.stats_col ? round_to<TX>(v * v) : v * v;
          }
          xs[tx * XS + row] = v;
        }
        for (int e = tid; e < KT * NT; e += THREADS) {
          const int k = e / NT;
          const int col = e % NT;
          const int gt = t0 + k;
          ws[e] = (gt < t_len && col < n) ? to_f32(w[(size_t)gt * n + col]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(&xs[k * XS + ty * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float b = ws[k * NT + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], b, acc[i][j]);
          }
        }
        __syncthreads();
      }

      // row statistics: the 16 lanes that share a row sum their parts
#pragma unroll
      for (int q = 0; q < (BM * KT) / THREADS; ++q) {
        float a = rs_p[q];
        float b = ss_p[q];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, off);
          b += __shfl_xor_sync(0xffffffffu, b, off);
        }
        if (tx == 0) {
          ss_ss[ty + 16 * q] = b;
          if (!p.stats_col) rs_ss[ty + 16 * q] = a;
        }
      }
      if (p.stats_col && tx == (n - 1) % 16) {
        // the ones column: Y[:, N-1] is the pre-centering row sum
        const int jl = (n - 1) / 16;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (j == jl)
#pragma unroll
            for (int i = 0; i < 4; ++i) rs_ss[ty * 4 + i] = acc[i][j];
      }
      __syncthreads();

      // epilogue: centre, round to the storage dtype, store Yc
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty * 4 + i;
        const long long gr = s0 + row;
        const float mu = rs_ss[row] * p.inv_t;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          const float cw = col < n ? p.colw[col] : 0.f;
          const float v = round_to<TY>(acc[i][j] - __fmul_rn(mu, cw));
          ycs_s[row * NT + col] = v;
          if (p.emit_yc && gr < m && col < n) yc[gr * n + col] = from_f32<TY>(v);
        }
      }
      if (tid < BM && s0 + tid < m) {
        const float rs = rs_ss[tid];
        const float ss = ss_ss[tid];
        if (p.scalar_stats) {
          part_rs2 += (double)rs * rs;
          part_ss += ss;
        } else {
          p.stats[(s0 + tid) * 2] = rs;
          p.stats[(s0 + tid) * 2 + 1] = ss;
        }
      }
      __syncthreads();
    }  // sub-tile

    // ---- phase 2a: partial G += Yc^T Yc, 64 x 64 output tiles ----------
    for (int at = 0; at < n_ot; ++at) {
      for (int bt = 0; bt < n_ot; ++bt) {
        float acc2[4][4] = {};
        for (int k = 0; k < MT; ++k) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(&ycs[k * NT + at * OT + ty * 4]);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b = ycs[k * NT + bt * OT + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc2[i][j] = fmaf(av[i], b, acc2[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int a = at * OT + ty * 4 + i;
            const int b = bt * OT + tx + 16 * j;
            if (a < n && b < n) {
              double* dst = &gp[(size_t)a * n + b];
              *dst = first ? (double)acc2[i][j] : *dst + acc2[i][j];
            }
          }
      }
    }

    // ---- phase 2b: partial C += Yc^T X, X re-read 64 columns at a time -
    for (int tt = 0; tt < t_len; tt += OT) {
      for (int e = tid; e < MT * OT; e += THREADS) {
        const int row = e / OT;
        const int k = e % OT;
        const long long gr = r0 + row;
        const int gt = tt + k;
        xs2[e] = (gr < m && gt < t_len) ? to_f32(x[gr * t_len + gt]) : 0.f;
      }
      __syncthreads();
      for (int at = 0; at < n_ot; ++at) {
        float acc2[4][4] = {};
        for (int k = 0; k < MT; ++k) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(&ycs[k * NT + at * OT + ty * 4]);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b = xs2[k * OT + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc2[i][j] = fmaf(av[i], b, acc2[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int a = at * OT + ty * 4 + i;
            const int b = tt + tx + 16 * j;
            if (a < n && b < t_len) {
              double* dst = &cp[(size_t)a * t_len + b];
              *dst = first ? (double)acc2[i][j] : *dst + acc2[i][j];
            }
          }
      }
      __syncthreads();
    }
    first = false;
  }

  if (p.scalar_stats) {
    red[0][tid] = part_rs2;
    red[1][tid] = part_ss;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
      if (tid < s) {
        red[0][tid] += red[0][tid + s];
        red[1][tid] += red[1][tid + s];
      }
      __syncthreads();
    }
    if (tid == 0) {
      p.st_part[blockIdx.x * 2] = red[0][0];
      p.st_part[blockIdx.x * 2 + 1] = red[1][0];
    }
  }
}

// Sum the per-CTA partials in CTA order (deterministic).
__global__ void scgp_reduce(const double* __restrict__ g_part,
                            const double* __restrict__ c_part,
                            const double* __restrict__ st_part, float* g,
                            float* c, float* st, int n_cta, long long n_g,
                            long long n_c, int scalar_stats) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  double s = 0.0;
  if (i < n_g) {
    for (int b = 0; b < n_cta; ++b) s += g_part[b * n_g + i];
    g[i] = (float)s;
  } else if (i < n_g + n_c) {
    const long long j = i - n_g;
    for (int b = 0; b < n_cta; ++b) s += c_part[b * n_c + j];
    c[j] = (float)s;
  } else if (scalar_stats && i < n_g + n_c + 2) {
    const long long j = i - n_g - n_c;
    for (int b = 0; b < n_cta; ++b) s += st_part[b * 2 + j];
    st[j] = (float)s;
  }
}

template <typename TX, typename TY, int NT>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(scgp_main<TX, TY, NT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(smem_floats(NT) * sizeof(float)));
}

struct Launch {
  const Params& p;
  int n_cta;
  cudaStream_t stream;
  template <typename TX, typename TY, int NT>
  cudaError_t run() const {
    cudaError_t err = allow_smem<TX, TY, NT>();
    if (err != cudaSuccess) return err;
    scgp_main<TX, TY, NT>
        <<<n_cta, THREADS, smem_floats(NT) * sizeof(float), stream>>>(p);
    return cudaGetLastError();
  }
};

struct Occupancy {
  int* ctas_per_sm;
  template <typename TX, typename TY, int NT>
  cudaError_t run() const {
    cudaError_t err = allow_smem<TX, TY, NT>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, scgp_main<TX, TY, NT>, THREADS,
        smem_floats(NT) * sizeof(float));
  }
};

// Picks the instance for the dtypes and N padded to 64, 128 or 256.
template <typename Op>
cudaError_t dispatch(const Op& op, int x_bf16, int out_bf16, int n) {
  using bf16 = __nv_bfloat16;
  const int nt = n <= 64 ? 64 : n <= 128 ? 128 : 256;
  if (x_bf16 && out_bf16) {
    return nt == 64    ? op.template run<bf16, bf16, 64>()
           : nt == 128 ? op.template run<bf16, bf16, 128>()
                       : op.template run<bf16, bf16, 256>();
  }
  if (x_bf16) {
    return nt == 64    ? op.template run<bf16, float, 64>()
           : nt == 128 ? op.template run<bf16, float, 128>()
                       : op.template run<bf16, float, 256>();
  }
  if (out_bf16) {
    return nt == 64    ? op.template run<float, bf16, 64>()
           : nt == 128 ? op.template run<float, bf16, 128>()
                       : op.template run<float, bf16, 256>();
  }
  return nt == 64    ? op.template run<float, float, 64>()
         : nt == 128 ? op.template run<float, float, 128>()
                     : op.template run<float, float, 256>();
}

}  // namespace

// CTAs of the main kernel that fit one SM at once, for these dtypes and
// this N, into *ctas_per_sm.  Returns a cudaError_t code.
extern "C" int scgp_ctas_per_sm(int x_bf16, int out_bf16, int n,
                                int* ctas_per_sm) {
  if (n < 1 || n > 256) return (int)cudaErrorInvalidValue;
  return (int)dispatch(Occupancy{ctas_per_sm}, x_bf16, out_bf16, n);
}

// Returns a cudaError_t code: 0 when both kernels were launched.
extern "C" int scgp_launch(const void* x, const void* w, const float* colw,
                           void* yc, float* stats, double* g_part,
                           double* c_part, double* st_part, float* g, float* c,
                           float* st, long long m, int t, int n, int x_bf16,
                           int out_bf16, int stats_col, int scalar_stats,
                           int emit_yc, float inv_t, int n_cta, void* stream) {
  if (n < 1 || n > 256 || t < 1 || m < 1 || n_cta < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{x,     w,    colw,      yc,           stats,   g_part,
                 c_part, st_part, m, t, n, stats_col, scalar_stats, emit_yc,
                 inv_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch(Launch{p, n_cta, s}, x_bf16, out_bf16, n);
  if (err != cudaSuccess) return (int)err;
  const long long n_g = (long long)n * n;
  const long long n_c = (long long)n * t;
  const long long total = n_g + n_c + 2;
  const int blocks = (int)((total + THREADS - 1) / THREADS);
  scgp_reduce<<<blocks, THREADS, 0, s>>>(g_part, c_part, st_part, g, c, st,
                                         n_cta, n_g, n_c, scalar_stats);
  return (int)cudaGetLastError();
}
