// K1 and K2 on Hopper: the fused sketch / centre / Gram / projection pass, in
// three tensor-core stages, and the two-pass fallback's first pass, its first
// two.
//
// Replaces dmd_era5_tpu/ops/matmul.py::_sketch_center_gram_project_kernel_1k
// (K1, the Pallas kernel behind sketch_center_gram_project) and
// _sketch_center_gram_kernel_1k and _sketch_center_gram_kernel (K2a and K2b,
// the whole-T and T-tiled kernels behind sketch_center_gram: Yc, the row
// statistics and G, no C; one function, split by whether T fits a TPU's VMEM
// block).  From the snapshot
// matrix X (M x T) and a sketch W (T x N) it computes
//
//   Y   = X W                          (f32 sums of f32-faithful products)
//   rs  = row sums of X, ss = row sums of x*x (the square rounded to the
//         storage dtype under stats_col, as the Pallas kernel squares in
//         the storage dtype)
//   Yc  = round_out(Y - (rs * inv_t) colsum(W))     stored in out dtype
//   G   = Yc^T Yc,  C = Yc^T X                      from the STORED Yc
//
// The Pallas kernel reads X once and sums G and C into resident blocks: a
// TPU is bound by its HBM there.  On an H100 the three products are bound by
// operations (at T 168, N 256, f32: 3 x M N (4T + N + 1) TF32 operations,
// 22.4 ms at 495 TFLOP/s, against ~20.5 ms for the bytes of the staged
// design below: X read twice, Yc written once and read twice), so the
// stages run apart, each on a tensor-core mainloop that keeps its sums on
// chip:
//
//   1. sketch  matmul_tc.cuh (K6's mainloop) with its CENTER epilogue:
//              persistent CTAs, W's column (24 to 128 wide) resident in
//              shared memory (tf32 hi/lo planes or bf16, in panels where it
//              does not fit), X by TMA (whole tiles by one bulk copy where
//              its f32 rows are not 16-byte aligned, element by element
//              otherwise), 3xTF32 or bf16 wgmma restarted every chunk (bf16:
//              every k16 step, two in flight); the row sums from the X
//              chunks in shared memory, Yc centred with __fmul_rn(mu,
//              colw), rounded to the out dtype and stored; the (M, 2)
//              statistics from CTA column 0, or its CTAs' f64 sums of rs^2
//              and ss, summed here in CTA order.
//   2. G       atb.cu (atb_wgmma.cuh's mainloop, K4's path and block
//              table, ops/atb.py::gram_block): Yc^T Yc on the upper blocks,
//              one block reading Yc once where N <= 128, mirrored.
//   3. C       K3's project.cu in ops/matmul.py::project_block's block,
//              Yc^T X (at the hourly year's f32 X its row-share route, as
//              the two passes take it).
//
// This library builds stage 1; the wrapper (ops/matmul.py::_scgp_plan)
// launches stage 2 from atb.cu's library and stage 3 from project.cu's on
// the stored Yc.
//
// Every stage sums in f32 from zero over at most a 128-row tile (the MMAs
// restart every 8-32 rows: the tensor core rounds toward zero) and adds
// those sums into f64, and reduces over CTAs or row shares in a fixed
// order: results are identical from run to run.  The f32 products are
// 3xTF32 (the counterpart of Precision.HIGHEST); bf16 x bf16 products are
// exact in f32 and take one bf16 pass; Yc of one dtype against X of the
// other takes the mixed 3xTF32 kernel (two products).
//
// The sketch's block (ops/matmul.py::matmul_block, center=True; the table
// that replaces the TPU tile sweeps of scripts/fused_tune2.py and
// pass1_tune.py): its columns a CTA the narrowest of matmul_tc.cuh's widths
// that holds N (config 2's N 76: 80), and 128 past it (two or more CTA
// columns).  Why 128 and not 112 there: device ms of the sketch stage alone
// at the week's X (M 15,573,600, T 168) on an H100 80GB HBM3 at 700 W (the
// parent mainloop of PR 9, scripts/torch_tc_tables.py; PERF.md):
//
//   N, dtype    112 columns   128 columns   columns
//   100 f32     14.03         14.85         112  one column either way
//   128 f32     27.97         12.25         128  one column against two
//   128 bf16    17.10         6.89          128
//   224 f32     28.68         26.32         128  two columns either way
//   256 f32     42.75         24.85         128  two columns against three
//
//   A 128-wide pass read ~12% under a 112-wide one though its MMAs are 14%
//   wider and its ring 2 chunks deep (its f32 planes take 168 KB at T 168).
//
// The block's T axis (matmul_block's stream): an f32 sketch holds W
// (resident up to 176 rows of K, past that restaged in 160-row panels every
// tile and panel) or streams it (split once a call into tf32 chunks that
// ride the ring beside X's, always 128 columns a CTA).  Device ms of the sketch stage alone, held
// against streamed, f32, at about the week's elements (M T ~2.6e9) and at
// the hourly year (M 977,400; scripts/torch_tc_tables.py --parts long_t,
// same card):
//
//   T        N 128            N 256            W
//   168      12.16 / 13.79    24.66 / 27.91    held: resident, no restage
//   176      11.84 / 13.44    24.06 / 27.21    held
//   192      17.90 / 12.76    35.58 / 25.85    streamed (the first T past
//   336      17.68 / 11.44    31.07 / 23.09    streamed  the resident depth)
//   2,048    14.71 /  9.65    28.61 / 19.21    streamed
//   8,760    46.76 / 31.20    91.43 / 61.66    streamed
//
//   so W streams for f32 X past 176 rows of K (where X's rows allow TMA;
//   else it is held), and is held otherwise: a resident W costs no copy,
//   and bf16 W stays held (resident to 704 rows).  At the year the restage
//   took 40% of the held sketch (the sketch with it skipped: 54.97 and 27.54
//   ms); the streamed one reads 12-13% above that, the copies of W's chunks
//   from L2 (32 KB beside each 16 KB chunk of X).
//
// Yc is written to device memory between the stages: with emit_yc off the
// wrapper allocates it as scratch.  The G and C stages' row-share scratch is
// n_share N^2 + n_share N T doubles, written once per CTA (none where one
// share holds all the rows).
//
// K2 is stages 1 and 2 (the wrapper's mask 3) with stats_col 0: the (M, 2)
// statistics from the f32 values of X, the square taken in f32, and no C,
// wherever ops/k2.py's table does not send it to sketch_center_gram.cu's
// clusters (bf16 X, W and Yc at N 257-512: the d = 3 Hankel pass).  So
// K2's sketch builds into this library and no second one of the same
// templates.  Its shapes on the main path here: f32 X of the hourly year
// (977,400 x 8,760) at N 256 and 128, where W streams, bound by the
// operations, 3 M N (2T + N + 1) in TF32 (27.0 and 13.4 ms).
//
// Ranges: any M, T and N (the wrapper routes N > 256 to K2 and K3, as the
// JAX package's entry does past its fused range; K2 takes N up to 2048);
// ragged edges masked.

#include "matmul_tc.cuh"

namespace {

// The sketch stage in the block ops/matmul.py::matmul_block chose (bn
// columns a CTA, copy path `load`, kw rows of K of W held, `stages` ring
// slots): W streamed (split into w_split first; f32 X by TMA at 128
// columns) where stream_w, else held.
template <typename TX>
cudaError_t sketch(const void* x, const void* w, void* w_split, void* yc, long long m, int t,
                   int n, int out_bf16, int bn, int load, int kw, int stages, int stream_w,
                   int ctas, const mm_tc::CenterArgs& ca, cudaStream_t stream) {
  if (stream_w) {
    if constexpr (sizeof(TX) == 4) {
      if (bn == 128 && load == mm_tc::TMA) {
        return mm_tc::launch_streamed<true>(x, w, w_split, yc, m, t, n, out_bf16, stages, ctas, ca,
                                            stream);
      }
    }
    return cudaErrorInvalidValue;
  }
  return mm_tc::with_kind(sizeof(TX) == 2, load, bn, [&](auto kind) -> cudaError_t {
    using K = decltype(kind);
    if constexpr (std::is_same_v<typename K::type, TX>) {
      return mm_tc::launch<TX, K::load, true, K::bn>(x, w, yc, m, t, n, out_bf16, kw, stages, ctas,
                                                     ca, stream);
    } else {
      return cudaErrorInvalidValue;
    }
  });
}

// The scalar statistics: the sketch CTAs' f64 sums, in CTA order.
__global__ void scgp_stats_reduce(const double* __restrict__ st_part, int n_cta, float* st) {
  const int j = threadIdx.x;
  if (j >= 2) return;
  double s = 0.0;
  for (int b = 0; b < n_cta; ++b) s += st_part[b * 2 + j];
  st[j] = (float)s;
}

// The sketch stage for X's (and W's) dtype TX: Yc, the statistics and, for
// scalar statistics, their reduction.
struct Launch {
  const void* x;
  const void* w;
  void* w_split;
  void* yc;
  mm_tc::CenterArgs ca;
  float* st;
  long long m;
  int t;
  int n;
  int out_bf16;
  int bn;  // the sketch's block
  int load;
  int kw;
  int ring;
  int stream_w;
  int sketch_ctas;
  cudaStream_t stream;
  template <typename TX>
  cudaError_t run() const {
    cudaError_t err = sketch<TX>(x, w, w_split, yc, m, t, n, out_bf16, bn, load, kw, ring, stream_w,
                                 sketch_ctas, ca, stream);
    if (err != cudaSuccess || ca.st_part == nullptr) return err;
    const int n_cta = mm_tc::grid_of(m, n, sketch_ctas, bn).x;
    scgp_stats_reduce<<<1, 32, 0, stream>>>(ca.st_part, n_cta, st);
    return cudaGetLastError();
  }
};

}  // namespace

// CTAs of the sketch stage's instantiation (X bf16 where x_bf16, else f32;
// bn columns a CTA, copy path `load`, W streamed where stream_w) that fit
// one SM at once with `smem` bytes of shared memory, into *out.  Returns a
// cudaError_t code.
extern "C" int scgp_sketch_ctas_per_sm(int x_bf16, int bn, int load, int stream_w, int smem,
                                       int* out) {
  if (stream_w) {
    return x_bf16 || bn != 128 || load != mm_tc::TMA
               ? (int)cudaErrorInvalidValue
               : (int)mm_tc::ctas_per_sm<float, mm_tc::TMA, true, 128, true>(smem, out);
  }
  return (int)mm_tc::with_kind(x_bf16, load, bn, [&](auto kind) {
    using K = decltype(kind);
    return mm_tc::ctas_per_sm<typename K::type, K::load, true, K::bn>(smem, out);
  });
}

// The sketch stage (K1's and K2's stage 1) on `stream`, in the block
// ops/matmul.py::matmul_block chose (bn columns a CTA, copy path `load`, kw
// rows of W held, `ring` slots, W streamed where stream_w; w_split then
// holds its split chunks), on sketch_ctas CTAs.  yc: M x N of the out
// dtype.  stats: M x 2, or null for the scalar statistics, which take
// st_part (sketch_ctas x 2 doubles) and st (2).  Returns a cudaError_t code:
// 0 when every kernel was launched.
extern "C" int scgp_launch(const void* x, const void* w, void* w_split, const float* colw,
                           void* yc, float* stats, double* st_part, float* st, long long m, int t,
                           int n, int x_bf16, int out_bf16, int stats_col, float inv_t, int bn,
                           int load, int kw, int ring, int stream_w, int sketch_ctas,
                           void* stream) {
  if (m < 1 || t < 1 || n < 1 || sketch_ctas < 1 || (stats == nullptr) == (st_part == nullptr) ||
      (st_part != nullptr && st == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const mm_tc::CenterArgs ca{colw, stats, st_part, inv_t, stats_col};
  const Launch op{x,  w,    w_split, yc, ca,   st,       m,           t,
                  n,  out_bf16, bn,   load, kw, ring, stream_w, sketch_ctas,
                  static_cast<cudaStream_t>(stream)};
  return (int)(x_bf16 ? op.run<atb_tc::bf16>() : op.run<float>());
}
