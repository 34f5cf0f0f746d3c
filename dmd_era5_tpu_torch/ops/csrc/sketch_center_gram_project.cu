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
//              persistent CTAs, W's 112- or 128-wide column resident in
//              shared memory (tf32 hi/lo planes or bf16, in panels past T
//              168 / 176 f32 and 672 / 704 bf16),
//              X by TMA (element by element where its rows are not 16-byte
//              aligned), 3xTF32 or bf16 wgmma restarted every chunk; the
//              row sums from the X chunks in shared memory, Yc centred with
//              __fmul_rn(mu, colw), rounded to the out dtype and stored;
//              the (M, 2) statistics from CTA column 0, or its CTAs' f64
//              sums of rs^2 and ss, summed here in CTA order.
//   2. G       row_share_atb_tc.cuh's wgmma kernels with `upper` (K4's
//              path, its block table): Yc^T Yc on the upper blocks,
//              diagonal blocks reading Yc once, mirrored by the reduction.
//   3. C       the same kernels without it (K3's path): Yc^T X.
//
// Every stage sums in f32 from zero over at most a 128-row tile (the MMAs
// restart every 8-32 rows: the tensor core rounds toward zero) and adds
// those sums into f64, and reduces over CTAs or row shares in a fixed
// order: results are identical from run to run.  The f32 products are
// 3xTF32 (the counterpart of Precision.HIGHEST); bf16 x bf16 products are
// exact in f32 and take one bf16 pass; Yc of one dtype against X of the
// other takes the mixed 3xTF32 kernel (two products).
//
// The sketch's columns a CTA (the table that replaces the TPU tile sweeps of
// scripts/fused_tune2.py and pass1_tune.py): device ms of the sketch stage
// alone at the week's X (M 15,573,600, T 168) on an H100 80GB HBM3 at 700 W
// (scripts/torch_tc_tables.py, which builds this source at each width;
// PERF.md):
//
//   N, dtype    112 columns   128 columns   columns
//   100 f32     14.03         14.85         112  one column either way
//   128 f32     27.97         12.25         128  one column against two
//   128 bf16    17.10         6.89          128
//   224 f32     28.68         26.32         128  two columns either way
//   256 f32     42.75         24.85         128  two columns against three
//
//   so 112 where one 112-wide column holds N, else 128.  A 128-wide pass
//   reads ~12% under a 112-wide one though its MMAs are 14% wider and its
//   ring 2 chunks deep (its f32 planes take 168 KB at T 168): the pass is
//   not bound by its MMAs (matmul_tc.cuh's note).  At the bench's shape
//   (M 2^19, T 512, N 128, where the TPU sweeps ran; --parts bench, the
//   same card): f32 1.165 / 1.163 ms at 112 / 128 columns (W held: 1.801;
//   the table streams it, 1.160), bf16 1.020 / 0.480: the table stands.
//
// The table's T axis, streams_w: an f32 sketch holds W (resident up to 176
// rows of K, past that restaged in 160-row panels every tile and panel) or
// streams it (split once a call into tf32 chunks that ride the ring beside
// X's, always 128 columns a CTA).  Device ms of the sketch stage alone, held
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
// wrapper allocates it as scratch.  The old CUDA-core kernel's per-CTA f64
// partials of G and C (about 80 bytes of traffic per element of X at T 168)
// are gone: the row-share scratch is n_share N^2 + n_share N T doubles,
// written once per CTA.
//
// K2 is stages 1 and 2 (the wrapper's mask 3) with stats_col 0: the (M, 2)
// statistics from the f32 values of X, the square taken in f32, and no C.
// So K2 builds into this library and no second one of the same templates.
// Its shapes on the main path: bf16 X (15,573,600 x 168) with N 384 and a
// bf16 Yc (the d = 3 Hankel pass: three 128-wide CTA columns, 6 upper
// 128-blocks of G), and f32 X of the hourly year (977,400 x 8,760) at N 256
// and 128, where W streams.  What bounds it there: at the d = 3 pass the
// bytes (X read once, Yc written: 5.17 ms; 4.4 ms of bf16 operations), at
// the year the operations, 3 M N (2T + N + 1) in TF32 (27.0 and 13.4 ms).
//
// Ranges: any M, T and N (the wrapper routes N > 256 to K2 and K3, as the
// JAX package's entry does past its fused range; K2 takes N up to 2048);
// ragged edges masked.

#include "matmul_tc.cuh"

namespace {

// The sketch's columns a CTA at width n where W is held (the table in the
// note above).
int sketch_columns(int n) { return n <= 112 ? 112 : 128; }

// Whether the sketch streams W at depth t (the T axis of the table in the
// note above): f32 X only; bf16 W stays held.
bool streams_w(int x_bf16, int t) { return !x_bf16 && t > 176; }

// Whether this call's sketch streams W: the table, and x's chunks by TMA.
template <typename TX>
bool streamed(const void* x, int t) {
  return sizeof(TX) == 4 && streams_w(0, t) && mm_tc::tma_ok<TX>(x, t);
}

// The sketch's columns a CTA: 128 where W streams, else the table's.
int sketch_bn(bool streamed, int n) { return streamed ? 128 : sketch_columns(n); }

// The sketch stage, W streamed (split into w_split first) or held at the
// columns a CTA of its table.
template <typename TX>
cudaError_t sketch(const void* x, const void* w, void* w_split, void* yc, long long m, int t,
                   int n, int out_bf16, int ctas, const mm_tc::CenterArgs& ca,
                   cudaStream_t stream) {
  if constexpr (sizeof(TX) == 4) {
    if (streamed<TX>(x, t)) {
      return mm_tc::dispatch_streamed<true, 128>(x, w, w_split, yc, m, t, n, out_bf16, ctas, ca,
                                                 stream);
    }
  }
  return sketch_columns(n) == 112
             ? mm_tc::dispatch<TX, true, 112>(x, w, yc, m, t, n, out_bf16, ctas, ca, stream)
             : mm_tc::dispatch<TX, true, 128>(x, w, yc, m, t, n, out_bf16, ctas, ca, stream);
}

// The scalar statistics: the sketch CTAs' f64 sums, in CTA order.
__global__ void scgp_stats_reduce(const double* __restrict__ st_part, int n_cta, float* st) {
  const int j = threadIdx.x;
  if (j >= 2) return;
  double s = 0.0;
  for (int b = 0; b < n_cta; ++b) s += st_part[b * 2 + j];
  st[j] = (float)s;
}

struct Launch {
  const void* x;
  const void* w;
  void* w_split;
  void* yc;
  mm_tc::CenterArgs ca;
  float* st;
  double* g_part;
  float* g;
  double* c_part;
  float* c;
  long long m;
  int t;
  int n;
  int out_bf16;
  int sketch_ctas;
  int g_shares;
  int c_shares;
  int stages;  // bit 0 sketch, bit 1 G, bit 2 C
  cudaStream_t stream;
  // TX: X's and W's dtype; TY: Yc's
  template <typename TX, typename TY>
  cudaError_t run() const {
    cudaError_t err = cudaSuccess;
    if (stages & 1) {
      err = sketch<TX>(x, w, w_split, yc, m, t, n, out_bf16, sketch_ctas, ca, stream);
      if (err != cudaSuccess) return err;
      if (ca.st_part != nullptr) {
        const int n_cta =
            mm_tc::grid_of(m, n, sketch_ctas, sketch_bn(streamed<TX>(x, t), n)).x;
        scgp_stats_reduce<<<1, 32, 0, stream>>>(ca.st_part, n_cta, st);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
      }
    }
    const TY* y = static_cast<const TY*>(yc);
    const TX* xt = static_cast<const TX*>(x);
    if (stages & 2) {
      err = atb_tc::with_gram_main<TY>(
          atb_tc::wgmma_rows_aligned(y, n, y, n), n, [&](const auto& main) {
            return atb_tc::launch(main, y, y, g_part, g, m, n, n, 1, g_shares, stream);
          });
      if (err != cudaSuccess) return err;
    }
    if (stages & 4) {
      err = atb_tc::launch(atb_tc::wgmma_main<TY, TX>(atb_tc::wgmma_rows_aligned(y, n, xt, t)), y,
                           xt, c_part, c, m, n, t, 0, c_shares, stream);
    }
    return err;
  }
};

struct Occupancy {
  int stage;
  int t;
  int n;
  int* out;
  template <typename TX, typename TY>
  cudaError_t run() const {
    // the aligned kernels'; the others take the same shared memory and
    // registers within the same launch bound (and one CTA an SM, as the
    // streamed kernel, where x's rows keep W held)
    if (stage == 0) {
      if constexpr (sizeof(TX) == 4) {
        if (streams_w(0, t)) return mm_tc::ctas_per_sm<float, true, 128, true>(t, out);
      }
      return sketch_columns(n) == 112 ? mm_tc::ctas_per_sm<TX, true, 112>(t, out)
                                      : mm_tc::ctas_per_sm<TX, true, 128>(t, out);
    }
    if (stage == 1) {
      return atb_tc::with_gram_main<TY>(
          true, n, [&](const auto& main) { return atb_tc::ctas_per_sm(main, out); });
    }
    return atb_tc::ctas_per_sm(atb_tc::wgmma_main<TY, TX>(true), out);
  }
};

}  // namespace

// Upper blocks of G (the G stage's CTAs a row share) for this Yc dtype and
// width n, at the block edge of K4's table (atb_tc::gram_edge).
extern "C" int scgp_gram_blocks(int out_bf16, int n) {
  return atb_tc::upper_blocks(n, atb_tc::gram_edge(out_bf16, n));
}

// Bytes of scratch the sketch takes for W's split chunks at depth t and width
// n: 0 where it holds W.
extern "C" long long scgp_w_stream_bytes(int x_bf16, int t, int n) {
  return streams_w(x_bf16, t) ? mm_tc::w_stream_bytes<128>(t, n) : 0;
}

// CTAs of one stage's kernel that fit one SM at once, for these dtypes and
// width n, into *out: 0 the sketch at depth t (at its table's columns a CTA),
// 1 G (at K4's block edge), 2 C.  Returns a cudaError_t code.
extern "C" int scgp_ctas_per_sm(int stage, int x_bf16, int out_bf16, int t, int n, int* out) {
  if (stage < 0 || stage > 2 || t < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return (int)atb_tc::dispatch(Occupancy{stage, t, n, out}, x_bf16, out_bf16);
}

// The stages in `stages` (bit 0 sketch, 1 G, 2 C; 7 for K1, 3 for K2, whose
// c_part and c may be null) on `stream`.  w_split: scgp_w_stream_bytes of
// scratch, or null where that is 0.  yc: M x N of the out dtype, written by
// the sketch.  stats: M x 2, or null for the scalar statistics, which take
// st_part (sketch_ctas x 2 doubles) and st (2).  The sketch at its table's
// columns a CTA, G at K4's block edge; g_part: g_shares N^2 doubles; c_part:
// c_shares N T.  Returns a cudaError_t code: 0 when every kernel was launched.
extern "C" int scgp_launch(const void* x, const void* w, void* w_split, const float* colw,
                           void* yc, float* stats, double* st_part, float* st, double* g_part,
                           float* g, double* c_part, float* c, long long m, int t, int n,
                           int x_bf16, int out_bf16, int stats_col, float inv_t, int sketch_ctas,
                           int g_shares, int c_shares, int stages, void* stream) {
  if (m < 1 || t < 1 || n < 1 || sketch_ctas < 1 || (stats == nullptr) == (st_part == nullptr) ||
      (st_part != nullptr && st == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const mm_tc::CenterArgs ca{colw, stats, st_part, inv_t, stats_col};
  const Launch op{x, w, w_split, yc, ca, st, g_part, g, c_part, c, m, t, n, out_bf16, sketch_ctas,
                  g_shares, c_shares, stages, static_cast<cudaStream_t>(stream)};
  return (int)atb_tc::dispatch(op, x_bf16, out_bf16);
}
