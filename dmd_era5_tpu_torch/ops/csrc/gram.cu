// K5 on Hopper: the bf16-split Gram matrix G = A^T A of a tall panel A
// (M x K, f32): A split as H = bf16(A), L = bf16(A - H), G ~= H^T H + H^T L
// + (H^T L)^T (L^T L dropped).  Replaces dmd_era5_tpu/ops/qr_panel.py::
// _gram_split_kernel behind gram(a, "bf16_split").  K4 (gram(a,
// "highest"), _gram_kernel) is atb.cu's: atb_wgmma.cuh's mainloop, or, for
// the f32 Grams where ops/atb.py::gram_block measured it faster (K 89-128
// and past 192 at more than one tile of rows), row_share_atb_tc.cuh's
// 128 x 128 one (atb_row_share_gram_launch).
//
// The Pallas grid runs in order and sums G into one resident block.  Here
// K5 runs on the tensor-core row-share kernel of gram_split_wgmma.cuh with
// `upper`: a CTA owns one upper block (bi <= bj) of G (G is symmetric, so
// the blocks below the diagonal are never computed) and one share of the
// rows of A, which it walks in 128-row tiles (grid-stride over tiles).
// Each tile's contribution is summed in f32 from zero and then added into
// an f64 sum: an f32 running sum over the ~118k rows a CTA sees at
// ERA5-week size makes G indefinite in its noise directions.  Each CTA
// writes its f64 block once; atb_reduce sums the row shares in a fixed
// order and mirrors the upper triangle into the lower one.  No atomics: G
// is identical from run to run and exactly symmetric.
//
// Each slab of A's block rows and columns is split once a CTA into bf16 H
// and L planes in shared memory, and each k16 step takes three warpgroup
// MMAs, L_i^T H_j + H_i^T L_j + H_i^T H_j, from zero, into f32 and every
// 128 rows into f64; their sum over the upper blocks is H^T H + H^T L +
// (H^T L)^T.  A bf16 x bf16 product is exact in f32.  Rows 16-byte aligned
// come by TMA from a producer warpgroup, others through registers.  What
// bounds it on an H100: 3 M K^2 bf16 operations (the upper half of three
// products) at 989 TFLOP/s against 4 M K bytes at 3.35 TB/s.
//   K <= 256 (the sketches, X, the CholQR leaves): the bytes, ~3 bf16
//   operations a byte of A.  One 128-wide block reads A once (96 < K <=
//   128).  What the card reads is the CTA's own chain a slab (loads,
//   split, MMAs, sums): 3.1x the bound at K 110 (scripts/torch_k5_phases.py).
//   K > 256 (the year's X, K 8,760: 2.25e14 operations, 228 ms): the
//   operations, at 128 x 128 blocks (4x the MMAs a staged byte of 64-wide
//   ones; 2,415 blocks at K 8,760, 1.03x the upper half).  What the card
//   reads is shared memory: a 16-row slab of a block moves ~112 KB through
//   it (the TMA copy 16, the split's read and write 32, the A fragments 8,
//   the MMAs' B operands 24, the f64 sums' read and write 32), ~875 clocks
//   at 128 bytes a clock against 384 clocks of MMAs, so the design overlaps
//   what it can: the split beside the MMAs, the fold spread over a tile's
//   slabs, the copies behind a producer warpgroup.  4.0x the bound.
//
// Block edges by K (split_edge: the table that replaces the TPU tile sweep
// of scripts/kernel_tune.py), device ms at the week's 15,573,600 rows and
// at the year's 977,400 on an H100 80GB HBM3 at 700 W
// (scripts/torch_tc_tables.py --parts split; PERF.md; a.T @ a beside):
//
//   K            128 x 128   64 x 64   a.T @ a   edge
//   64           5.04        1.97      3.06      64   one block against one
//   96           5.10        6.76      8.87      64   for the CholQR2 leaf,
//   96 (4,096 rows) 0.0201   0.0138    0.0110         K5's one width here on
//                                                     the main path
//   110          6.30        10.83     8.88      128  one block read once
//   168          17.02       13.14     25.93     64   three blocks against six
//   256          17.71       22.30     36.37     128  three against ten
//   8,760        921.1       1,710.4   2,897.4   128  four times the MMAs a
//                                                     staged byte
//
// Ranges: any K (the JAX kernel stops at 1024, where its K x K accumulator
// no longer fits VMEM).  The f64 scratch in device memory is n_share * K * K
// doubles.  The ragged last tile and the columns past K are masked
// in-kernel (zero rows and columns add nothing), so A is never padded or
// copied.

#include "gram_split_wgmma.cuh"

namespace {

// K5's block edge at width k (the table above).
int split_edge(int k) { return k <= 96 || (k > 128 && k <= 192) ? 64 : 128; }

// op.run<BT, TMA>() at the block edge of the table above, by TMA where a's
// rows allow it.
template <typename Op>
cudaError_t with_main(int k, bool tma, const Op& op) {
  if (split_edge(k) == 64) return tma ? op.template run<64, true>() : op.template run<64, false>();
  return tma ? op.template run<128, true>() : op.template run<128, false>();
}

struct Launch {
  const float* a;
  double* part;
  float* g;
  long long m;
  int k;
  int n_share;
  cudaStream_t stream;
  template <int BT, bool TMA>
  cudaError_t run() const {
    return k5::launch<BT, TMA>(a, part, g, m, k, n_share, stream);
  }
};

struct Occupancy {
  int* out;
  template <int BT, bool TMA>
  cudaError_t run() const {
    return k5::ctas_per_sm<BT>(out);  // as many CTAs an SM by either load
  }
};

}  // namespace

// Upper blocks of G (the kernel's CTAs a row share) at width k, at the edge
// of the table above.
extern "C" int gram_upper_blocks(int k) { return atb_tc::upper_blocks(k, split_edge(k)); }

// CTAs of the kernel at width k that fit one SM at once, into
// *ctas_per_sm.  Returns a cudaError_t code.
extern "C" int gram_ctas_per_sm(int k, int* ctas_per_sm) {
  return (int)with_main(k, true, Occupancy{ctas_per_sm});
}

// G (k x k, f32) of a (m x k, row-major, f32) split into bf16 H and L, over
// n_share row shares, in the blocks of the table above; part holds n_share
// * k * k doubles of scratch.  Returns a cudaError_t code: 0 when both
// kernels were launched.
extern "C" int gram_launch(const float* a, double* part, float* g, long long m, int k, int n_share,
                           void* stream) {
  if (m < 1 || k < 1 || n_share < 1) return (int)cudaErrorInvalidValue;
  return (int)with_main(k, k5::tma_rows(a, m, k),
                        Launch{a, part, g, m, k, n_share, static_cast<cudaStream_t>(stream)});
}
