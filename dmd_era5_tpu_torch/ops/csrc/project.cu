// K3 on Hopper: the projection C = Y^T X of the two-pass fallback.
//
// Replaces dmd_era5_tpu/ops/matmul.py::_project_kernel (the Pallas kernel
// behind project()), the second pass of sketch_center_gram_project's
// fallback for long time axes: C (N x T) = Y^T X from one streaming read
// of X (M x T) and Y (M x N), summed over the M rows.
//
// The Pallas grid walks row blocks in order and adds into one resident
// (N, block_t) accumulator.  Here CTAs run concurrently: a CTA owns one
// 64 x 64 block of C (64 sketch columns by 64 time steps) and one share of
// the rows, with f32 sums per 128-row tile added into f64 sums in
// registers and one fixed-order reduction over the shares
// (row_share_atb.cuh).  The CTAs of one block row of C run next to one
// another in launch order and read the same rows of X and Y at about the
// same time, so the re-reads come from L2.
//
// What bounds it on an H100: 2 M N T flops against (M T + M N) element
// reads.  At the hourly year (M 977,400, T 8,760, N 256, f32) that is
// about 4.4e12 flops against 35 GB, ~124 flops per byte, so a kernel on
// the f32 CUDA cores (67 TFLOP/s) is bound by arithmetic (~65 ms), not by
// HBM (~11 ms).  This first version is a plain shared-memory tiled kernel,
// 4 x 4 outputs per thread, full f32 FMAs (the JAX package's HIGHEST; bf16
// operands are upcast, their products exact in f32), no load/compute
// overlap.  Tensor cores and TMA pipelines are later work and must keep
// the f64-grade accumulation.
//
// Ranges: any M, N and T, Y and X each f32 or bf16; ragged edges masked.
// Scratch: n_share * N * T doubles (17.9 MB a share at N 256, T 8,760),
// sized and capped by the wrapper.

#include "row_share_atb.cuh"

namespace {

struct Launch {
  const void* y;
  const void* x;
  double* part;
  float* c;
  long long m;
  int n;
  int t;
  int n_share;
  cudaStream_t stream;
  template <typename TY, typename TX>
  cudaError_t run() const {
    return atb::launch<TY, TX>(static_cast<const TY*>(y), static_cast<const TX*>(x),
                               part, c, m, n, t, 0, n_share, stream);
  }
};

}  // namespace

// CTAs of the main kernel that fit one SM at once, into *out.
extern "C" int project_ctas_per_sm(int y_bf16, int x_bf16, int* out) {
  return (int)atb::dispatch(atb::Occupancy{out}, y_bf16, x_bf16);
}

// C (n x t, f32) = Y^T X; part holds n_share * n * t doubles.  Returns a
// cudaError_t code: 0 when both kernels were launched.
extern "C" int project_launch(const void* y, const void* x, double* part, float* c,
                              long long m, int n, int t, int y_bf16, int x_bf16,
                              int n_share, void* stream) {
  const Launch op{y, x, part, c, m, n, t, n_share, static_cast<cudaStream_t>(stream)};
  return (int)atb::dispatch(op, y_bf16, x_bf16);
}
