// K4 at "highest" and the G stages of K1 and K2 on Hopper: G = A^T A over
// the rows of a tall row-major panel A (M x K, f32 or bf16), exactly
// symmetric, on atb_wgmma.cuh's mainloop (its note says what it replaces,
// what bounds it and how): the blocks of G holding entries r <= c,
// mirrored, each reading its columns from A's slab where they lie within
// the block's rows.  Replaces dmd_era5_tpu/ops/qr_panel.py::_gram_kernel
// (gram.cu keeps K5) and the G sums of K1 and K2 (G = Yc^T Yc of the stored
// Yc, after sketch_center_gram_project.cu's sketch stage; their C stage is
// K3's, project.cu).
//
// The block of each call is the wrapper's (ops/atb.py::gram_block, the
// table that replaces the TPU tile sweeps): the width N of the blocks on
// the MMA's n side, one of the widths below, with the f64 sums in
// registers (N <= 64), in shared memory (72-88), or in shared memory with
// two CTAs an SM (32-64, f32).  The row shares are the wrapper's too: with
// one share (part null) each CTA writes its block of G straight from its
// f64 sums, in one launch.
//
// Ranges: any M and K.  Scratch: n_share K^2 doubles, sized and capped by
// the wrapper.

#include "atb_wgmma.cuh"

namespace {

using atb_tc::bf16;

// The table's widths: every multiple of 8 to 64 with the f64 sums in
// registers, 72-88 in shared memory (a Gram of one block to K 88), and, for
// f32 (the Grams of two m blocks), 32-64 with the f64 sums in shared memory
// and two CTAs an SM.
using RegWidths = std::integer_sequence<int, 8, 16, 24, 32, 40, 48, 56, 64>;
using SmemWidths = std::integer_sequence<int, 72, 80, 88>;
using DualWidths = std::integer_sequence<int, 32, 40, 48, 56, 64>;

template <typename T, int KIND, typename Op, int... W>
cudaError_t by_width(const Op& op, int n, std::integer_sequence<int, W...>) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((n == W && ((err = op.template run<T, W, KIND>()), true)) || ...);
  return err;
}

template <typename T, typename Op>
cudaError_t by_kind(const Op& op, int n, int kind) {
  switch (kind) {
    case atbw::REG_SUMS:
      return by_width<T, atbw::REG_SUMS>(op, n, RegWidths{});
    case atbw::SMEM_SUMS:
      return by_width<T, atbw::SMEM_SUMS>(op, n, SmemWidths{});
    case atbw::DUAL_SUMS:
      if constexpr (std::is_same_v<T, float>) {
        return by_width<T, atbw::DUAL_SUMS>(op, n, DualWidths{});
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// op.run<T, N, KIND>() for A's type at block width n, the f64 sums where
// `kind` (atbw::SumsKind) puts them.
template <typename Op>
cudaError_t dispatch(const Op& op, int a_bf16, int n, int kind) {
  return a_bf16 ? by_kind<bf16>(op, n, kind) : by_kind<float>(op, n, kind);
}

struct Launch {
  atbw::Params p;
  cudaStream_t stream;
  template <typename T, int W, int KIND>
  cudaError_t run() const {
    return atbw::launch<T, W, KIND>(p, stream);
  }
};

struct Occupancy {
  int* out;
  template <typename T, int W, int KIND>
  cudaError_t run() const {
    return atbw::ctas_per_sm<T, W, KIND>(out);
  }
};

struct Modes {
  atbw::Params* p;
  template <typename T, int W, int KIND>
  cudaError_t run() const {
    atbw::modes<T, W, KIND>(*p);
    return cudaSuccess;
  }
};

}  // namespace

// CTAs of the kernel for A's type and this block that fit one SM at once,
// into *out.  Returns a cudaError_t code.
extern "C" int atb_ctas_per_sm(int a_bf16, int block_n, int sums, int* out) {
  return (int)dispatch(Occupancy{out}, a_bf16, block_n, sums);
}

// G = A^T A (k x k f32, exactly symmetric) of a (m x k, row-major, f32 or
// bf16).  block_n, sums: the blocks' width on the n side and where their
// f64 sums live (atbw::SumsKind).  part: n_share k^2 doubles, or null for
// one launch without scratch (n_share 1).  early: a slab's slot refilled
// beside the next slab's MMAs.  Returns a cudaError_t code: 0 when every
// kernel was launched.
extern "C" int atb_launch(const void* a, double* part, float* g, long long m, int k, int a_bf16,
                          int block_n, int sums, int early, int n_share, void* stream) {
  if (part == nullptr && n_share != 1) return (int)cudaErrorInvalidValue;
  atbw::Params p{};
  p.a = a;
  p.part = part;
  p.out = g;
  p.m = m;
  p.k = k;
  p.early = early;
  p.n_share = n_share;
  const Launch op{p, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(op, a_bf16, block_n, sums);
}

// How atb_launch would bring in a's slabs for these arguments, as
// k3::Mode (0 bulk copy, 1 TMA boxes, 2 element by element), into
// *mode_a (the blocks' rows) and *mode_b (their columns, where they are
// not read from the rows' slab).  Returns a cudaError_t code.
extern "C" int atb_modes(const void* a, long long m, int k, int a_bf16, int block_n, int sums,
                         int* mode_a, int* mode_b) {
  atbw::Params p{};
  p.a = a;
  p.m = m;
  p.k = k;
  const cudaError_t err = dispatch(Modes{&p}, a_bf16, block_n, sums);
  *mode_a = p.mode_a;
  *mode_b = p.mode_b;
  return (int)err;
}

// The row-share mainloop of row_share_atb_tc.cuh (atb_wgmma_tf32x3 with
// `upper`, 128 x 128 blocks, loads staged through registers), which the
// table keeps for the f32 Grams where it reads faster than this library's
// (ops/atb.py::gram_block): G (k x k) of a (m x k, f32) over n_share row
// shares, part n_share k^2 doubles.  Returns a cudaError_t code.
extern "C" int atb_row_share_gram_launch(const float* a, double* part, float* g, long long m, int k,
                                         int n_share, void* stream) {
  const bool aligned = atb_tc::wgmma_rows_aligned(a, k, a, k);
  return (int)atb_tc::launch(atb_tc::wgmma_main<float, float>(aligned), a, a, part, g, m, k, k, 1,
                             n_share, static_cast<cudaStream_t>(stream));
}

// CTAs of that kernel that fit one SM at once, into *out.
extern "C" int atb_row_share_ctas_per_sm(int* out) {
  return (int)atb_tc::ctas_per_sm(atb_tc::wgmma_main<float, float>(true), out);
}
