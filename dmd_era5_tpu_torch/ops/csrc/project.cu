// K3 on Hopper: the projection C = Y^T X of the two-pass fallback, of the
// Hankel projection and of the one-pass and updating SVDs.
//
// Replaces dmd_era5_tpu/ops/matmul.py::_project_kernel (the Pallas kernel
// behind project()): C (N x T) = Y^T X from one streaming read of X (M x T)
// and Y (M x N), summed over the M rows.  The Pallas grid walks row blocks
// in order and adds into one resident (N, block_t) accumulator; here CTAs
// run concurrently, each on one block of C and one share of the rows, and
// their f64 sums are reduced over the shares in a fixed order.  The kernel
// is project_wgmma.cuh's: blocks shaped to C (its narrow side on the MMA's
// n), a producer warpgroup's bulk copies and TMA boxes on an mbarrier ring,
// f64 sums in registers where they fit; its note says what bounds it.
//
// The block of each call is the wrapper's choice (ops/matmul.py::
// project_block): which operand goes on the m side (trans: X), and the
// width n of the blocks on the n side, one of the table's widths below,
// with the f64 sums in registers or in shared memory.
//
// Ranges: any M, N and T, Y and X each f32 or bf16 (an f32 x bf16 pair with
// its f32 operand on the m side); ragged edges masked.  Scratch: n_share *
// N * T doubles, sized and capped by the wrapper.

#include "project_wgmma.cuh"

namespace {

// The tile table: the block widths of the kernel, every multiple of 8 up
// to 88, the f64 sums in registers up to 64 and in shared memory past it
// (ops/matmul.py's _PROJECT_N_MAX, _PROJECT_REG_N, _PROJECT_SMEM_WIDTHS).
using RegWidths = std::integer_sequence<int, 8, 16, 24, 32, 40, 48, 56, 64>;
using SmemWidths = std::integer_sequence<int, 72, 80, 88>;

template <typename TA, typename TB, bool S, typename Op, int... W>
cudaError_t by_width(const Op& op, int n, std::integer_sequence<int, W...>) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((n == W && ((err = op.template run<TA, TB, W, S>()), true)) || ...);
  return err;
}

template <typename TA, typename TB, typename Op>
cudaError_t by_block(const Op& op, int n, int smem_sums) {
  return smem_sums ? by_width<TA, TB, true>(op, n, SmemWidths{})
                   : by_width<TA, TB, false>(op, n, RegWidths{});
}

// op.run<TA, TB, N, SSUMS>() for the m side's and the n side's types at
// block width n.
template <typename Op>
cudaError_t dispatch(const Op& op, int a_bf16, int b_bf16, int n, int smem_sums) {
  using atb_tc::bf16;
  if (a_bf16 && !b_bf16) return cudaErrorInvalidValue;  // the f32 operand goes on the m side
  if (a_bf16) return by_block<bf16, bf16>(op, n, smem_sums);
  if (b_bf16) return by_block<float, bf16>(op, n, smem_sums);
  return by_block<float, float>(op, n, smem_sums);
}

struct Launch {
  k3::Params p;
  float* c;
  int n;
  int t;
  cudaStream_t stream;
  template <typename TA, typename TB, int W, bool S>
  cudaError_t run() const {
    return k3::launch<TA, TB, W, S>(p, c, n, t, stream);
  }
};

struct Occupancy {
  int* out;
  template <typename TA, typename TB, int W, bool S>
  cudaError_t run() const {
    return k3::ctas_per_sm<TA, TB, W, S>(out);
  }
};

// block_n 0: the row-share mainloop (row_share_atb_tc.cuh: 128 x 128 blocks
// of C, f64 sums in shared memory, loads staged through registers), which
// the table keeps for f32 x f32 where project_wgmma is measured slower (the
// f32 year).
struct RowShareLaunch {
  const float* y;
  const float* x;
  double* part;
  float* c;
  long long m;
  int n;
  int t;
  int n_share;
  cudaStream_t stream;
  cudaError_t run() const {
    const bool aligned = atb_tc::wgmma_rows_aligned(y, n, x, t);
    return atb_tc::launch(atb_tc::wgmma_main<float, float>(aligned), y, x, part, c, m, n, t, 0,
                          n_share, stream);
  }
};

}  // namespace

// CTAs of the kernel for these operand types and block that fit one SM at
// once, into *out.
extern "C" int project_ctas_per_sm(int y_bf16, int x_bf16, int trans, int block_n, int smem_sums,
                                   int* out) {
  if (block_n == 0) {
    return y_bf16 || x_bf16 ? (int)cudaErrorInvalidValue
                            : (int)atb_tc::ctas_per_sm(atb_tc::wgmma_main<float, float>(true), out);
  }
  return (int)dispatch(Occupancy{out}, trans ? x_bf16 : y_bf16, trans ? y_bf16 : x_bf16, block_n,
                       smem_sums);
}

// C (n x t, f32) = Y^T X; part holds n_share * n * t doubles.  trans: X on
// the m side (C's blocks computed as blocks of C^T); block_n: the blocks'
// width on the n side, or 0 for the row-share mainloop (f32 x f32);
// smem_sums: their f64 sums in shared memory.
// Returns a cudaError_t code: 0 when both kernels were launched.
extern "C" int project_launch(const void* y, const void* x, double* part, float* c, long long m,
                              int n, int t, int y_bf16, int x_bf16, int trans, int block_n,
                              int smem_sums, int n_share, void* stream) {
  if (block_n == 0) {
    if (y_bf16 || x_bf16) return (int)cudaErrorInvalidValue;  // f32 x f32 only
    const RowShareLaunch op{static_cast<const float*>(y), static_cast<const float*>(x), part, c,
                            m, n, t, n_share, static_cast<cudaStream_t>(stream)};
    return (int)op.run();
  }
  k3::Params p{};
  p.a = trans ? x : y;
  p.b = trans ? y : x;
  p.part = part;
  p.m = m;
  p.cols_a = trans ? t : n;
  p.cols_b = trans ? n : t;
  p.trans = trans;
  p.n_share = n_share;
  const Launch op{p, c, n, t, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(op, trans ? x_bf16 : y_bf16, trans ? y_bf16 : x_bf16, block_n, smem_sums);
}
