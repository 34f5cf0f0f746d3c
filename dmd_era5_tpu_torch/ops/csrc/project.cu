// K3 on Hopper: the projection C = Y^T X of the two-pass fallback.
//
// Replaces dmd_era5_tpu/ops/matmul.py::_project_kernel (the Pallas kernel
// behind project()), the second pass of sketch_center_gram_project's
// fallback for long time axes: C (N x T) = Y^T X from one streaming read
// of X (M x T) and Y (M x N), summed over the M rows.
//
// The Pallas grid walks row blocks in order and adds into one resident
// (N, block_t) accumulator.  Here CTAs run concurrently: a CTA owns one
// 128 x 128 block of C (128 sketch columns by 128 time steps) and one share
// of the rows, on the tensor-core row-share mainloop of
// row_share_atb_tc.cuh: MMA sums per 128-row tile added into f64 sums and
// one fixed-order reduction over the shares: atb_wgmma_tf32x3 for f32 x f32
// and for mixed f32 x bf16 operands, atb_wgmma_bf16 for bf16 x bf16.
//
// What bounds it on an H100: 2 M N T useful flops against (M T + M N)
// element reads.  With f32 operands (the year: M 977,400, T 8,760, N 256 or
// 128; the fit step) the products are 3xTF32, three tensor-core passes, so
// 3 x 2 M N T operations at 495 TFLOP/s: 26.6 ms at N 256 against 10.5 ms of
// HBM, bound by operations.  The design puts the three passes on warpgroup
// MMAs, which run beside the splitting of the next slab; B is split once a
// CTA and A once a warp.  With bf16 operands (the d = 3 pass: the week, M
// 15,573,600, T 168, N 384) one bf16 pass: 2 M N T at 989 TFLOP/s is 2.0 ms
// against 5.1 ms to read X and Y once, bound by bytes; 128-wide blocks cut
// the re-reads of X and Y (each read by N/128 resp. T/128 CTAs, from L2 when
// those CTAs run together) and the next slab's loads are in flight while
// the MMAs run.  The f64 tile sums cost a fixed read and write of the CTA's
// 128 KB of shared sums every 128 rows, which at the d = 3 shape is about as
// much shared-memory traffic as the slabs themselves.  Rows that are not
// aligned to a whole load take another instantiation of the same kernel,
// which loads element by element (a runtime choice cost ~4%).
//
// Ranges: any M, N and T, Y and X each f32 or bf16; ragged edges masked.
// Scratch: n_share * N * T doubles (17.9 MB a share at N 256, T 8,760),
// sized and capped by the wrapper.

#include "row_share_atb_tc.cuh"

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
    const TY* yt = static_cast<const TY*>(y);
    const TX* xt = static_cast<const TX*>(x);
    const bool aligned = atb_tc::wgmma_rows_aligned(yt, n, xt, t);
    return atb_tc::launch(atb_tc::wgmma_main<TY, TX>(aligned), yt, xt, part, c, m, n, t, 0,
                          n_share, stream);
  }
};

struct Occupancy {
  int* out;
  template <typename TY, typename TX>
  cudaError_t run() const {
    // the aligned kernel's; the other takes the same shared memory and
    // registers within the same one-CTA launch bound
    return atb_tc::ctas_per_sm(atb_tc::wgmma_main<TY, TX>(true), out);
  }
};

}  // namespace

// CTAs of the main kernel that fit one SM at once, into *out.
extern "C" int project_ctas_per_sm(int y_bf16, int x_bf16, int* out) {
  return (int)atb_tc::dispatch(Occupancy{out}, y_bf16, x_bf16);
}

// Edge of the blocks of C that the main kernel's CTAs own.
extern "C" int project_block_edge() { return atb_tc::wg::BT; }

// C (n x t, f32) = Y^T X; part holds n_share * n * t doubles.  Returns a
// cudaError_t code: 0 when both kernels were launched.
extern "C" int project_launch(const void* y, const void* x, double* part, float* c,
                              long long m, int n, int t, int y_bf16, int x_bf16,
                              int n_share, void* stream) {
  const Launch op{y, x, part, c, m, n, t, n_share, static_cast<cudaStream_t>(stream)};
  return (int)atb_tc::dispatch(op, y_bf16, x_bf16);
}
