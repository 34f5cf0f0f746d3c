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
// both run on the tensor-core row-share mainloop of row_share_atb_tc.cuh
// with `upper`: a CTA owns one upper block (bi <= bj) of G (G is symmetric,
// so the blocks below the diagonal are never computed) and one share of the
// rows of A, which it walks in 128-row tiles (grid-stride over tiles).
// Each tile's contribution is summed in f32 from zero (the MMAs restart
// every 8-32 rows: the tensor core rounds toward zero) and then added into
// an f64 sum: an f32 running sum over the ~118k rows a CTA sees at
// ERA5-week size makes G indefinite in its noise directions.  Each CTA
// writes its f64 block once; atb_reduce sums the row shares in a fixed
// order and mirrors the upper triangle into the lower one.  No atomics: G
// is identical from run to run and exactly symmetric.
//
// K4 takes the wgmma kernels: 3xTF32 for f32 A (atb_wgmma_tf32x3: hi =
// tf32(a), lo = a - hi, lo.hi + hi.lo + hi.hi, the counterpart of
// HIGHEST) and one bf16 pass for bf16 A (atb_wgmma_bf16: products exact in
// f32).  A diagonal block reads its slab of A once and takes its A
// fragments from B's shared copy.  What bounds it on an H100: at K 168 (the
// week's X) and 110 (its sketch) the bytes, 4 M K at 3.35 TB/s (3.1 and 2.0
// ms), against 3 M K (K + 1) TF32 operations of the upper half at 495
// TFLOP/s (2.6 and 1.1 ms); 128-wide blocks pad that to 3 x 128^2 at K 168
// (3.5x the upper half) and 128^2 at K 110 (2.7x).  What the card reads is
// neither: the CTA's loads, splits, MMAs and f64 sums run in turn (as K3's,
// PERF.md), ~40% of the TF32 rate on the blocks.
//
// K5 (the bf16 split) runs on atb_split_bf16 (mma.sync on a cp.async ring):
// H and L are formed in registers once per element a warp loads, and each
// upper block takes three bf16 MMAs, H_i^T H_j + H_i^T L_j + L_i^T H_j,
// into one f32 accumulator; their sum over the blocks is H^T H + H^T L +
// (H^T L)^T.  A bf16 x bf16 product is exact in f32.  What bounds it on an
// H100: 3 M K^2 bf16 operations (the upper half of three products) at 989
// TFLOP/s against 4 M K bytes at 3.35 TB/s; at K 110 and 168 the bytes (~3
// bf16 operations per byte of A), at the year's K 8,760 the operations
// (2.25e14, 228 ms).
//
// Block edges by K (the table that replaces the TPU tile sweep of
// scripts/kernel_tune.py).  K4, f32 A, device ms at the week's 15,573,600
// rows on an H100 80GB HBM3 at 700 W (scripts/torch_tc_tables.py, which
// builds this source at each edge; PERF.md; a.T @ a beside):
//
//   K          128 x 128   64 x 64   a.T @ a   edge
//   110        7.55        11.35     9.13      128  one block
//   128        7.17        10.34     9.04      128  one block against three
//   168        23.27       20.25     26.21     64   three blocks padded to
//                                                   256^2 against six
//   256        23.79       33.37     35.92     128  three blocks against ten
//
//   so K4 and K1's G stage take 64-wide blocks for 128 < K <= 192
//   (atb_tc::gram_edge), 128 elsewhere; a 64 x 64 block costs ~0.45 of a
//   128 x 128 one for a quarter of its MMAs (twice the loads an output).
//   At the bench's shape (M 2^19, K 128, the fit step's Yc at T 512;
//   --parts bench, the same card): K4 0.283 / 0.375 ms at edge 128 / 64,
//   K1's G stage 0.284 / 0.373, a.T @ a 0.338; bf16 0.161 (128 only): the
//   table stands.
//   bf16 A: 128 x 128 (the bf16 kernel's one shape).
//   K5, K <= 256  64 x 64  K 110: 3 blocks, 2.0x the upper half's entries;
//                          K 168: 6 blocks, 1.7x (128-wide blocks: 2.7x and
//                          3.5x for the same L2 traffic, 3 KB a row at 168)
//   K5, K > 256 128 x 128  four times the MMAs per staged byte; at K 8,760
//                          2,415 blocks, 1.03x; a CTA row of blocks shares
//                          its A slice from L2
//
// Ranges: any K (the JAX kernel stops at 1024, where its K x K accumulator
// no longer fits VMEM).  The f64 scratch in device memory is n_share * K * K
// doubles.  The ragged last tile and the columns past K are masked
// in-kernel (zero rows and columns add nothing), so A is never padded or
// copied.

#include "row_share_atb_tc.cuh"

namespace {

using atb_tc::bf16;

// K5's block edge at width k (the table above; K4's is atb_tc::gram_edge).
int split_edge(int k) { return k <= 256 ? 64 : 128; }

// The main kernel at width k, at the block edge of the table above: K4
// (split 0) for f32 or bf16 a, K5 (split 1) for f32 a.
template <typename Op>
cudaError_t with_main(int a_bf16, int split, int k, const Op& op) {
  if (split) {
    if (a_bf16) return cudaErrorInvalidValue;
    return split_edge(k) == 64 ? op(atb_tc::split_main<64>()) : op(atb_tc::split_main<128>());
  }
  return a_bf16 ? atb_tc::with_gram_main<bf16>(op.aligned_bf16(), k, op)
                : atb_tc::with_gram_main<float>(op.aligned_f32(), k, op);
}

struct Launch {
  const void* a;
  double* part;
  float* g;
  long long m;
  int k;
  int n_share;
  cudaStream_t stream;
  bool aligned_f32() const {
    const float* af = static_cast<const float*>(a);
    return atb_tc::wgmma_rows_aligned(af, k, af, k);
  }
  bool aligned_bf16() const {
    const bf16* ab = static_cast<const bf16*>(a);
    return atb_tc::wgmma_rows_aligned(ab, k, ab, k);
  }
  template <typename T>
  cudaError_t operator()(const atb_tc::Main<T, T>& main) const {
    const T* at = static_cast<const T*>(a);
    return atb_tc::launch(main, at, at, part, g, m, k, k, 1, n_share, stream);
  }
};

struct Occupancy {
  int* out;
  bool aligned_f32() const { return true; }  // the aligned kernel's; the other takes the same
  bool aligned_bf16() const { return true; }  // shared memory and registers within one bound
  template <typename T>
  cudaError_t operator()(const atb_tc::Main<T, T>& main) const {
    return atb_tc::ctas_per_sm(main, out);
  }
};

}  // namespace

// Upper blocks of G (the main kernel's CTAs a row share) at width k: K4
// (split 0) for f32 or bf16 A, K5 (split 1), at the edge of the table above.
extern "C" int gram_upper_blocks(int a_bf16, int split, int k) {
  return atb_tc::upper_blocks(k, split ? split_edge(k) : atb_tc::gram_edge(a_bf16, k));
}

// CTAs of the main kernel at width k that fit one SM at once, into
// *ctas_per_sm.  Returns a cudaError_t code.
extern "C" int gram_ctas_per_sm(int a_bf16, int split, int k, int* ctas_per_sm) {
  return (int)with_main(a_bf16, split, k, Occupancy{ctas_per_sm});
}

// G (k x k, f32) of a (m x k, row-major, f32 or bf16) over n_share row
// shares, in the blocks of the table above; part holds n_share * k * k
// doubles of scratch.  Returns a cudaError_t code: 0 when both kernels were
// launched.
extern "C" int gram_launch(const void* a, double* part, float* g, long long m, int k, int a_bf16,
                           int split, int n_share, void* stream) {
  if (m < 1 || k < 1 || n_share < 1) return (int)cudaErrorInvalidValue;
  return (int)with_main(a_bf16, split, k,
                        Launch{a, part, g, m, k, n_share, static_cast<cudaStream_t>(stream)});
}
