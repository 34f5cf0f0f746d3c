// K6 on Hopper: out = x @ w, summed in f32, on the tensor cores.
//
// Replaces the Pallas kernel dmd_era5_tpu/ops/matmul.py::_matmul_kernel
// (:79, behind matmul, :101), the per-block sketch of the out-of-core SVD
// (dmd_era5_tpu/pipeline/streamed_fit.py:166-185): each streamed row block
// X_blk (65,536 x 168 at ERA5-week size) times the (168 x 110) iterate w.
// The product's precision follows the operand type, as the JAX kernel's
// (_dot_precision, :41-52):
//
//   f32 x f32 -> 3xTF32, the counterpart of Precision.HIGHEST: hi = tf32(a)
//                rounded to nearest, lo = a - hi from the ROUNDED hi (the
//                tensor core drops the 13 low bits it is handed), and
//                lo.hi + hi.lo + hi.hi summed in f32 (atb_tc::split_tf32,
//                as K3).  One TF32 pass (~1e-3) would be another function.
//   bf16 x bf16 -> one bf16 pass (DEFAULT): products exact in f32.
//
// The output is f32, or bf16 rounded from the f32 sum.
//
// What bounds it on an H100.  A tall x streams past a small iterate: at
// the streamed block (M 65,536, K 168, N 110) x and out are 73 MB in f32,
// 0.022 ms at 3.35 TB/s, against 3 x 2 M K N = 7.3 G TF32 operations,
// 0.015 ms at 495 TFLOP/s; with bf16 operands 51 MB, 0.015 ms, against 2.4
// G bf16 operations, 0.002 ms.  Bytes bound both, so the design streams x
// once, keeps w out of the stream and keeps x's loads in flight beside the
// MMAs.  The mainloop (persistent CTAs, w resident in shared memory, x by TMA,
// 3xTF32 or bf16 wgmma, the tile table) is matmul_tc.cuh's.
//
// Ranges: any M, K and N; x row-major and contiguous, w row-major.

#include "matmul_tc.cuh"

// CTAs of the kernel that fit one SM at once at depth k, into *out.
extern "C" int matmul_ctas_per_sm(int x_bf16, int k, int* out) {
  return (int)(x_bf16 ? mm_tc::ctas_per_sm<atb_tc::bf16, false, 112>(k, out)
                      : mm_tc::ctas_per_sm<float, false, 112>(k, out));
}

// out (m x n, f32 or bf16) = x (m x k) @ w (k x n), both row-major and of
// one dtype (f32, or bf16 when x_bf16), on at most `ctas` CTAs (the card's
// resident ones).  Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int matmul_launch(const void* x, const void* w, void* out, long long m, int k, int n,
                             int x_bf16, int out_bf16, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const mm_tc::CenterArgs none{};
  return (int)(x_bf16 ? mm_tc::dispatch<atb_tc::bf16, false, 112>(x, w, out, m, k, n, out_bf16, ctas, none, s)
                      : mm_tc::dispatch<float, false, 112>(x, w, out, m, k, n, out_bf16, ctas, none, s));
}
