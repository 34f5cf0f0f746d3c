// K7 on Hopper: Householder QR of one tall panel A (m x n), n <= 256, with
// the panel resident on chip across P co-resident CTAs.
//
// Replaces the Pallas kernel dmd_era5_tpu/ops/qr_panel.py::
// _householder_kernel (:212, behind householder_panel, :290), the
// backward-stable TSQR leaf (dmd_era5_tpu/ops/tsqr.py:91-98) that
// re-orthonormalises the (T x r) iterate of the streamed randomized SVD
// between its passes.  It computes what the Pallas kernel computes, column
// by column j:
//
//   sigma = |A[j:, j]|^2;  sign = +1 where a_jj >= 0, else -1;
//   alpha = -sign sqrt(sigma);  v = A[j:, j] - alpha e_j;
//   beta = 2 / v^T v, or 0 where v^T v = 0;
//   A[j:, j:] -= v (beta v^T A[j:, j:])
//
// then R = the upper triangle of the first n rows and Q = H_0 ... H_{n-1}
// I[:, :n], and takes diag(R) >= 0 itself (sign(0) -> +1): row j of R and
// column j of Q are written with alpha_j's sign.  All sums are f32, in
// another order than the Pallas kernel's.
//
// What bounds it.  4 m n^2 - 4 n^3 / 3 f32 flops and 8 m n + 4 n^2 bytes
// are microseconds at most on an H100 (0.016 ms at 4,096 x 256).  The
// factorization is a chain of n dependent reflectors, each of which needs
// sums over every row of the panel before any row can take it, so what
// bounds it is the latency of n dependent exchanges, and the instructions
// each step issues between them, against the library QR's time.
//
// The design.  The rows are split into P contiguous shares, one CTA of 256
// threads an SM, launched cooperatively so that all are resident (P = 1:
// an ordinary launch, every exchange a block barrier).  Thread (g, q)
// holds columns 4 q .. 4 q + 3 of rows g, g + G, ... of its share in
// registers (G = 256 / ceil(n / 4) row groups, K <= 32 rows a thread) for the
// whole factorization; device memory sees only the first read of A, the
// exchanges and the last writes of Q and R.  A step loads the reflector's
// entry of each row once (a broadcast from shared memory) for four FMAs,
// with no branch.  The reflectors stay below the diagonal of their
// columns, as LAPACK stores them.  One exchange a reflector: after a CTA
// applies reflector j - 1 to its rows, it takes the dot products of the
// new column j, over its rows below row j, with every column (c >= j:
// v^T A and sigma; c < j: y_j = V^T v_j for the compact WY form), sums
// them over its row groups and stores each sum with the step's tag in one
// 64-bit word of a double-buffered global slot (j mod 2); the CTA that
// holds row j stores row j so.  Every CTA polls the P slots, 32 bytes a
// load, until each word carries the step's tag: the data is its own flag,
// so a step costs one round trip through L2 and no grid barrier.  All CTAs
// sum the P partials in the same fixed order with the same code, so all of
// them apply bitwise-identical reflectors.
//
// Q by the compact WY form, Q = I[:, :n] - V T V_top^T, without forming T:
// T's recurrence T[0:j, j] = -beta_j T[0:j, 0:j] y_j, T[j, j] = beta_j
// gives, for W = V T, W[:, j] = beta_j (v_j - W[:, 0:j] y_j), one dot a row
// and no chain across rows.  Each CTA builds its rows of W in shared memory
// (the share's rows x n, where the panel would be) a column a step, during
// the next step's exchange; the CTA that holds row j writes R's row j and
// V's row j of the top n x n block to device memory as the reflector is
// known.  After the last reflector and one grid barrier (a counter, zeroed
// with the slots by the caller), each CTA loads V_top^T (column-major,
// each column zero-padded to whole float4s: ~n (n+1) / 2 floats) and
// writes its rows of Q = I[:, :n] - W V_top^T: f32 FMAs on the CUDA cores,
// 16 FMAs a float4 of a row.  Shared memory then holds W, V_top^T and the
// exchange's buffers: at n = 256 a share of at most 80 rows, at n = 110
// the registers' 288.  That is n exchanges and one barrier, against 2 n
// dependent sweeps in the Pallas kernel.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int N_MAX = 256;
constexpr int K_MAX = 32;  // rows a thread holds, at most (4 columns each, in registers)
constexpr int BATCH = 4;   // source CTAs in flight a polling thread

typedef unsigned long long u64;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Column c of an n x n upper triangle, zero-padded to whole float4s: rows
// 0..c at cs(c), cs(c) = sum over l < c of round4(l + 1).
__host__ __device__ inline int cs(int c) {
  const int a = c >> 2, b = c & 3;
  return 4 * (a + 1) * (2 * a + b);
}

__host__ __device__ inline int share_start(int p, int m, int P) {
  return (int)((long long)p * m / P);
}

__host__ __device__ inline int row_groups(int n) { return THREADS / (round4(n) / 4); }

// Offsets, in floats, of the arrays in dynamic shared memory.  The total is
// rows_cap ns + cs(n) + 2 K_MAX G + 8 THREADS + 8 ns floats (ns the row
// stride round4(n), G the row groups), the formula of ops/qr_panel.py::
// _householder_smem_bytes.
struct Layout {
  int w, vt, vbuf, part, seg, xslot, xrow, rowbuf, ybuf, vdiag, sgn, total;
};

__host__ __device__ inline Layout layout(int rows_cap, int n) {
  const int ns = round4(n);
  Layout L;
  L.w = 0;                                      // W = V T: rows_cap x ns
  L.vt = L.w + rows_cap * ns;                   // V_top^T: cs(n)
  L.vbuf = L.vt + cs(n);                        // the reflector's column: 2 x K_MAX G
  L.part = L.vbuf + 2 * K_MAX * row_groups(n);  // per-thread partial dots: G x ns
  L.seg = L.part + 4 * THREADS;                 // per-segment sums of the P partials
  L.xslot = L.seg + 4 * THREADS;                // P = 1: the exchange's sums, 2 x ns
  L.xrow = L.xslot + 2 * ns;                    // P = 1: the exchange's row j, 2 x ns
  L.rowbuf = L.xrow + 2 * ns;                   // row j
  L.ybuf = L.rowbuf + ns;                       // y_j = V^T v_j (past j: v^T A)
  L.vdiag = L.ybuf + ns;                        // v_jj
  L.sgn = L.vdiag + ns;                         // sign of alpha_j
  L.total = L.sgn + ns;
  return L;
}

__device__ __forceinline__ void st_tagged(u64* p, unsigned tag, float x) {
  const u64 w = ((u64)tag << 32) | __float_as_uint(x);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

// four consecutive exchange words (32-byte aligned), each read whole
__device__ __forceinline__ void ld_words4(const u64* p, u64 (&w)[4]) {
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(w[0]), "=l"(w[1]) : "l"(p) : "memory");
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(w[2]), "=l"(w[3]) : "l"(p + 2) : "memory");
}

__device__ __forceinline__ bool tagged(const u64 (&w)[4], unsigned tag) {
  return (unsigned)(w[0] >> 32) == tag && (unsigned)(w[1] >> 32) == tag &&
         (unsigned)(w[2] >> 32) == tag && (unsigned)(w[3] >> 32) == tag;
}

// the four words once each carries the tag; a writer that never comes (a
// CTA not resident) traps after ~10 s instead of hanging the card
__device__ __forceinline__ void wait_tagged(const u64* p, u64 (&w)[4], unsigned tag) {
  if (!tagged(w, tag)) {
    const long long t0 = clock64();
    do {
      if (clock64() - t0 > 20000000000LL) __trap();
      ld_words4(p, w);
    } while (!tagged(w, tag));
  }
}

__device__ __forceinline__ float word_value(u64 w) { return __uint_as_float((unsigned)w); }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every CTA's writes before it are visible to every CTA after it.
__device__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const long long t0 = clock64();
    while (ld_acquire(count) < target) {
      if (clock64() - t0 > 20000000000LL) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// out[k][u] = sum over l of rows[li_k, l] tri[cs(c_u) + l], c_u = 4 q + u,
// for the K rows of thread (g, q): the rows and the triangle's columns four
// entries a load (the triangle's padding and the rows' entries past their
// diagonal are zero).
template <int K>
__device__ void rows_times_tri(const float* rows, int ns, const float* tri_, int n, int q,
                               int g, int G, int nrows, float (&out)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int u = 0; u < 4; ++u) out[k][u] = 0.f;
  }
  const int top = 4 * q + 3;
  for (int l = 0; l <= top; l += 4) {
    float4 t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 4 * q + u;
      t[u] = l <= c && c < n ? *reinterpret_cast<const float4*>(tri_ + cs(c) + l)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int li = g + k * G;
      if (li < nrows) {
        const float4 x = *reinterpret_cast<const float4*>(rows + li * ns + l);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          out[k][u] = fmaf(x.x, t[u].x, out[k][u]);
          out[k][u] = fmaf(x.y, t[u].y, out[k][u]);
          out[k][u] = fmaf(x.z, t[u].z, out[k][u]);
          out[k][u] = fmaf(x.w, t[u].w, out[k][u]);
        }
      }
    }
  }
}

// W[li, j] = beta (v_i - W[li, 0:j] y[0:j]) for the share's rows li, a
// thread a row: W's columns j and past are still 0, so the dot runs over
// whole float4s.
__device__ void w_column(float* W, int ns, int rows, int r0, const float* vcol, float vjj,
                         const float* y, float beta, int j) {
  const int l4 = (j + 3) >> 2;
  const float4* y4 = reinterpret_cast<const float4*>(y);
  for (int li = threadIdx.x; li < rows; li += THREADS) {
    const float4* w4 = reinterpret_cast<const float4*>(W + li * ns);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
    for (int l = 0; l < l4; ++l) {
      const float4 a = w4[l], b = y4[l];
      s0 = fmaf(a.x, b.x, s0);
      s1 = fmaf(a.y, b.y, s1);
      s2 = fmaf(a.z, b.z, s2);
      s3 = fmaf(a.w, b.w, s3);
    }
    const int i = r0 + li;
    const float v = i > j ? vcol[li] : (i == j ? vjj : 0.f);
    W[li * ns + j] = beta * (v - ((s0 + s1) + (s2 + s3)));
  }
}

// xg (P > 1): the tagged exchange, slot[2][P][ns] and row[2][ns] words, then
// the final barrier's word, all zero at launch.  vtop: V_top^T, column c
// (row c of V_top) at cs(c), zero-padded.
template <int K, bool SINGLE>
__global__ void __launch_bounds__(THREADS, 1)
    householder_kernel(const float* __restrict__ a, float* __restrict__ q_out,
                       float* __restrict__ r, u64* xg, float* vtop, int m, int n, int P) {
  extern __shared__ __align__(16) float sm[];
  const int p = blockIdx.x;
  const int r0 = share_start(p, m, P);
  const int rows = share_start(p + 1, m, P) - r0;
  const int rows_cap = (m + P - 1) / P;
  const int ns = round4(n);
  const int quads = ns / 4;
  const Layout L = layout(rows_cap, n);
  float* W = sm + L.w;
  float* part = sm + L.part;
  float* ybuf = sm + L.ybuf;
  float* vdiag = sm + L.vdiag;
  float* sgn = sm + L.sgn;
  u64* gslot = xg;
  u64* grow = xg + 2 * P * ns;

  const int tid = threadIdx.x;
  const int G = row_groups(n);  // thread (g, q) = g quads + q: columns 4 q .. 4 q + 3
  const int g = tid / quads, q = tid % quads;
  const bool lane_on = g < G;
  const int S = SINGLE ? 1 : min(G, P);  // segments of the sum over the P partials
  const int vstride = K_MAX * G;         // one of vbuf's two columns

  for (int e = tid; e < rows_cap * ns; e += THREADS) W[e] = 0.f;

  float x[K][4];  // columns 4 q + u of rows g + k G of the share (0 past the panel)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int li = g + k * G;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 4 * q + u;
      x[k][u] = lane_on && li < rows && c < n ? a[(size_t)(r0 + li) * n + c] : 0.f;
    }
  }

  // row j of the panel as it enters step j, from the threads that hold it
  auto write_row = [&](int j) {
    const int li = j - r0;
    if (lane_on && li >= 0 && li < rows && li % G == g) {
      const int kj = li / G;
      float v[4];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k == kj) {
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = x[k][u];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (SINGLE) {
          sm[L.xrow + (j & 1) * ns + 4 * q + u] = v[u];
        } else {
          st_tagged(grow + (j & 1) * ns + 4 * q + u, j + 1, v[u]);
        }
      }
    }
  };
  // column c of the share to vbuf's column `col`, from the threads that hold it
  auto column_out = [&](int c, int col) {
    if (lane_on && q == c >> 2) {
      float* dst = sm + L.vbuf + col * vstride;
      const int u = c & 3;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        dst[g + k * G] = u == 0 ? x[k][0] : u == 1 ? x[k][1] : u == 2 ? x[k][2] : x[k][3];
      }
    }
  };
  // this CTA's dots of vbuf's column `col` with every column, over its rows
  // below row `below`, summed over the row groups by the next exchange
  auto dots = [&](int col, int below) {
    const float* v = sm + L.vbuf + col * vstride;
    float pc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int li = g + k * G;
      const float vk = r0 + li > below && li < rows ? v[li] : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) pc[u] = fmaf(vk, x[k][u], pc[u]);
    }
    if (lane_on) *reinterpret_cast<float4*>(part + g * ns + 4 * q) = make_float4(pc[0], pc[1], pc[2], pc[3]);
  };

  column_out(0, 0);
  write_row(0);
  __syncthreads();
  dots(0, 0);  // column 0's dots with every column, below row 0

  float beta_prev = 0.f;
  int step_p = 0;  // j mod P
  for (int j = 0; j < n; ++j) {
    // the exchange: this CTA's sums over its row groups out, W's column
    // j - 1 meanwhile, then the P partials in, summed in fixed order
    __syncthreads();
    if (tid < ns) {
      float s = 0.f;
      for (int gg = 0; gg < G; ++gg) s += part[gg * ns + tid];
      if constexpr (SINGLE) {
        sm[L.xslot + (j & 1) * ns + tid] = s;
      } else {
        st_tagged(gslot + ((j & 1) * P + p) * ns + tid, j + 1, s);
      }
    }
    if (j > 0) {
      w_column(W, ns, rows, r0, sm + L.vbuf + ((j - 1) & 1) * vstride, vdiag[j - 1], ybuf,
               beta_prev, j - 1);
    }
    const float* segp;
    const float* rowp;
    if constexpr (SINGLE) {
      __syncthreads();
      segp = sm + L.xslot + (j & 1) * ns;
      rowp = sm + L.xrow + (j & 1) * ns;
    } else {
      float* seg = sm + L.seg;
      float* rowbuf = sm + L.rowbuf;
      const unsigned tag = j + 1;
      u64 rw[4];
      const u64* rsrc = grow + (j & 1) * ns + 4 * tid;
      if (tid < quads) ld_words4(rsrc, rw);
      if (lane_on && g < S) {
        const u64* src = gslot + (j & 1) * P * ns + 4 * q;
        const int hi = (g + 1) * P / S;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        for (int base = g * P / S; base < hi; base += BATCH) {
          u64 w[BATCH][4];
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            if (base + b < hi) ld_words4(src + (base + b) * ns, w[b]);
          }
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            if (base + b < hi) {
              wait_tagged(src + (base + b) * ns, w[b], tag);
#pragma unroll
              for (int u = 0; u < 4; ++u) s[u] += word_value(w[b][u]);
            }
          }
        }
        *reinterpret_cast<float4*>(seg + g * ns + 4 * q) = make_float4(s[0], s[1], s[2], s[3]);
      }
      if (tid < quads) {
        wait_tagged(rsrc, rw, tag);
        *reinterpret_cast<float4*>(rowbuf + 4 * tid) =
            make_float4(word_value(rw[0]), word_value(rw[1]), word_value(rw[2]), word_value(rw[3]));
      }
      __syncthreads();
      segp = seg;
      rowp = rowbuf;
    }

    // the reflector, the same in every thread of every CTA
    const bool holds_row_j = P == 1 || p == step_p;  // writes R's and V_top's row j
    step_p = step_p + 1 == P ? 0 : step_p + 1;
    const float ajj = rowp[j];
    float below = 0.f;  // sum over rows below j of column j squared
    for (int k = 0; k < S; ++k) below += segp[k * ns + j];
    const float alpha = -(ajj >= 0.f ? 1.f : -1.f) * sqrtf(fmaf(ajj, ajj, below));
    const float vjj = ajj - alpha;
    const float vtv = fmaf(vjj, vjj, below);
    const float beta = vtv > 0.f ? 2.f / vtv : 0.f;
    const float sgn_j = alpha < 0.f ? -1.f : 1.f;
    float wc[4];  // beta v^T A[j:, c] for j < c < n, else 0
    {
      const float4 r4 = *reinterpret_cast<const float4*>(rowp + 4 * q);
      float4 t4 = *reinterpret_cast<const float4*>(segp + 4 * q);
      for (int k = 1; k < S; ++k) {
        const float4 u4 = *reinterpret_cast<const float4*>(segp + k * ns + 4 * q);
        t4.x += u4.x;
        t4.y += u4.y;
        t4.z += u4.z;
        t4.w += u4.w;
      }
      const float row[4] = {r4.x, r4.y, r4.z, r4.w};
      const float dot[4] = {fmaf(vjj, r4.x, t4.x), fmaf(vjj, r4.y, t4.y),  // v^T A[j:, c]
                            fmaf(vjj, r4.z, t4.z), fmaf(vjj, r4.w, t4.w)};
#pragma unroll
      for (int u = 0; u < 4; ++u) wc[u] = 4 * q + u > j && 4 * q + u < n ? beta * dot[u] : 0.f;
      if (lane_on && g == 0) {
        *reinterpret_cast<float4*>(ybuf + 4 * q) = make_float4(dot[0], dot[1], dot[2], dot[3]);
        if (holds_row_j) {  // R's row j; V_top's row j, zero-padded
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = 4 * q + u;
            if (c < n) {
              r[(size_t)j * n + c] =
                  c < j ? 0.f : (c == j ? fabsf(alpha) : sgn_j * fmaf(-vjj, wc[u], row[u]));
            }
            if (c <= (j | 3)) vtop[cs(j) + c] = c < j ? row[u] : (c == j ? vjj : 0.f);
          }
        }
      }
    }
    if (tid == 0) {
      vdiag[j] = vjj;
      sgn[j] = sgn_j;
    }
    beta_prev = beta;

    // reflector j on the rows below j: the others, and the columns at or
    // left of j, take -0 w or -v 0 and keep their values; rows past the
    // share stay 0 (their v is 0)
    if (lane_on) {
      const float* vcur = sm + L.vbuf + (j & 1) * vstride;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float v = r0 + g + k * G > j ? vcur[g + k * G] : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) x[k][u] = fmaf(-v, wc[u], x[k][u]);
      }
    }
    if (j + 1 == n) break;
    column_out(j + 1, (j + 1) & 1);
    write_row(j + 1);
    __syncthreads();
    dots((j + 1) & 1, j + 1);  // column j + 1's dots with every column below row j + 1
  }

  // W's last column; V_top complete in device memory after a barrier
  __syncthreads();
  w_column(W, ns, rows, r0, sm + L.vbuf + ((n - 1) & 1) * vstride, vdiag[n - 1], ybuf, beta_prev,
           n - 1);
  if constexpr (SINGLE) {
    __syncthreads();
  } else {
    grid_barrier(reinterpret_cast<unsigned*>(xg + 2 * P * ns + 2 * ns), P);
  }
  float* Vt = sm + L.vt;
  for (int e = tid; e < cs(n); e += THREADS) Vt[e] = __ldcg(vtop + e);
  __syncthreads();

  // Q = I[:, :n] - W V_top^T, column c times the sign of alpha_c
  if (lane_on) {
    float acc[K][4];
    rows_times_tri<K>(W, ns, Vt, n, q, g, G, rows, acc);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int li = g + k * G;
      const int i = r0 + li;
      if (li < rows) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = 4 * q + u;
          if (c < n) q_out[(size_t)i * n + c] = sgn[c] * ((i == c ? 1.f : 0.f) - acc[k][u]);
        }
      }
    }
  }
}

template <int K, bool SINGLE>
cudaError_t launch(const float* a, float* q, float* r, u64* xg, float* vtop, int m, int n,
                   int P, int bytes, cudaStream_t s) {
  static int allowed[64] = {};  // the opt-in maximum, set once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (allowed[dev] < bytes) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    if (bytes > optin) return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(householder_kernel<K, SINGLE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    allowed[dev] = optin;
  }
  if constexpr (SINGLE) {
    householder_kernel<K, true><<<1, THREADS, bytes, s>>>(a, q, r, xg, vtop, m, n, P);
    return cudaGetLastError();
  } else {
    void* args[] = {(void*)&a, (void*)&q, (void*)&r, (void*)&xg, (void*)&vtop,
                    (void*)&m, (void*)&n, (void*)&P};
    return cudaLaunchCooperativeKernel((const void*)householder_kernel<K, false>, dim3(P),
                                       dim3(THREADS), args, (size_t)bytes, s);
  }
}

template <bool SINGLE>
cudaError_t launch_k(int k, const float* a, float* q, float* r, u64* xg, float* vtop, int m,
                     int n, int P, int bytes, cudaStream_t s) {
  if (k <= 4) return launch<4, SINGLE>(a, q, r, xg, vtop, m, n, P, bytes, s);
  if (k <= 8) return launch<8, SINGLE>(a, q, r, xg, vtop, m, n, P, bytes, s);
  if (k <= 16) return launch<16, SINGLE>(a, q, r, xg, vtop, m, n, P, bytes, s);
  if (k <= 20) return launch<20, SINGLE>(a, q, r, xg, vtop, m, n, P, bytes, s);
  if (k <= 24) return launch<24, SINGLE>(a, q, r, xg, vtop, m, n, P, bytes, s);
  return launch<K_MAX, SINGLE>(a, q, r, xg, vtop, m, n, P, bytes, s);
}

}  // namespace

// The shared memory a CTA may opt into on device dev, in bytes.
extern "C" int householder_smem_optin(int dev, int* out) {
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Q (m x n) and R (n x n), diag(R) >= 0, of a row-major f32 panel a
// (m x n), m >= n, 1 <= n <= 256, on P CTAs (1 <= P <= m, all resident,
// at most 32 G rows a CTA, G = 256 / (round4(n) / 4)).  xg (P > 1):
// 2 (P + 1) round4(n) + 1 zeroed 64-bit words; vtop: cs(n) floats.
// Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int householder_launch(const float* a, float* q, float* r, void* xg, float* vtop,
                                  int m, int n, int P, void* stream) {
  if (n < 1 || n > N_MAX || m < n || P < 1 || P > m) return (int)cudaErrorInvalidValue;
  const int rows_cap = (m + P - 1) / P;
  const int k = (rows_cap + row_groups(n) - 1) / row_groups(n);
  if (k > K_MAX) return (int)cudaErrorInvalidValue;
  const int bytes = (int)(sizeof(float) * layout(rows_cap, n).total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* words = static_cast<u64*>(xg);
  return (int)(P == 1 ? launch_k<true>(k, a, q, r, words, vtop, m, n, P, bytes, s)
                      : launch_k<false>(k, a, q, r, words, vtop, m, n, P, bytes, s));
}
