// K1 on Hopper: the fused sketch / centre / Gram / projection pass, in three
// tensor-core stages.
//
// Replaces dmd_era5_tpu/ops/matmul.py::_sketch_center_gram_project_kernel_1k
// (the Pallas kernel behind sketch_center_gram_project).  From the snapshot
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
//   not bound by its MMAs (matmul_tc.cuh's note).
//
// Yc is written to device memory between the stages: with emit_yc off the
// wrapper allocates it as scratch.  The old CUDA-core kernel's per-CTA f64
// partials of G and C (about 80 bytes of traffic per element of X at T 168)
// are gone: the row-share scratch is n_share N^2 + n_share N T doubles,
// written once per CTA.
//
// Ranges: any M, T and N (the wrapper routes N > 256 to K2 and K3, as the
// JAX package's entry does past its fused range); ragged edges masked.

#include "matmul_tc.cuh"

namespace {

// The sketch's columns a CTA at width n (the table in the note above).
int sketch_columns(int n) { return n <= 112 ? 112 : 128; }

// The sketch stage at the columns a CTA of its table.
template <typename TX>
cudaError_t sketch(const void* x, const void* w, void* yc, long long m, int t, int n,
                   int out_bf16, int ctas, const mm_tc::CenterArgs& ca, cudaStream_t stream) {
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
      err = sketch<TX>(x, w, yc, m, t, n, out_bf16, sketch_ctas, ca, stream);
      if (err != cudaSuccess) return err;
      if (ca.st_part != nullptr) {
        const int n_cta = mm_tc::grid_of(m, n, sketch_ctas, sketch_columns(n)).x;
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
    // registers within the same launch bound
    if (stage == 0) {
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

// CTAs of one stage's kernel that fit one SM at once, for these dtypes and
// width n, into *out: 0 the sketch at depth t (at its table's columns a CTA),
// 1 G (at K4's block edge), 2 C.  Returns a cudaError_t code.
extern "C" int scgp_ctas_per_sm(int stage, int x_bf16, int out_bf16, int t, int n, int* out) {
  if (stage < 0 || stage > 2 || t < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return (int)atb::dispatch(Occupancy{stage, t, n, out}, x_bf16, out_bf16);
}

// The stages in `stages` (bit 0 sketch, 1 G, 2 C; 7 for the function) on
// `stream`.  yc: M x N of the out dtype, written by the sketch.  stats: M x 2,
// or null for the scalar statistics, which take st_part (sketch_ctas x 2
// doubles) and st (2).  The sketch at its table's columns a CTA, G at K4's
// block edge; g_part: g_shares N^2 doubles; c_part: c_shares N T.
// Returns a cudaError_t code: 0 when every kernel was launched.
extern "C" int scgp_launch(const void* x, const void* w, const float* colw, void* yc, float* stats,
                           double* st_part, float* st, double* g_part, float* g, double* c_part,
                           float* c, long long m, int t, int n, int x_bf16, int out_bf16,
                           int stats_col, float inv_t, int sketch_ctas, int g_shares,
                           int c_shares, int stages, void* stream) {
  if (m < 1 || t < 1 || n < 1 || sketch_ctas < 1 || (stats == nullptr) == (st_part == nullptr) ||
      (st_part != nullptr && st == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const mm_tc::CenterArgs ca{colw, stats, st_part, inv_t, stats_col};
  const Launch op{x, w, yc, ca, st, g_part, g, c_part, c, m, t, n, out_bf16, sketch_ctas,
                  g_shares, c_shares, stages, static_cast<cudaStream_t>(stream)};
  return (int)atb::dispatch(op, x_bf16, out_bf16);
}
