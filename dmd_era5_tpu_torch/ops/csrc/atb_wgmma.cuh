// The row-share Gram mainloop on Hopper's warpgroup MMAs, f64-grade: K4
// (G = A^T A at "highest", ops/qr_panel.py::gram) and the G stages of K1
// and K2 (ops/matmul.py::sketch_center_gram_project / sketch_center_gram,
// G = Yc^T Yc; their C stage is K3's, project_wgmma.cuh).  atb.cu launches
// it.  It replaces the G sums of dmd_era5_tpu/ops/qr_panel.py::_gram_kernel
// and of dmd_era5_tpu/ops/matmul.py::_sketch_center_gram_project_kernel_1k
// (and of _sketch_center_gram_kernel_1k / _sketch_center_gram_kernel),
// whose precision it keeps: f32 as 3xTF32 (lo.hi + hi.lo + hi.hi, hi =
// tf32(a) rounded to nearest, atb_tc::split_tf32), bf16 as one bf16 pass.
//
// A is M x K, row-major; the reduction runs over the rows.  A CTA owns one
// block of G holding an entry r <= c, BM = 128 of its rows (the MMA's m
// side: two warpgroups of m64, A's columns m0 on) by N of its columns (the
// n side, a wgmma width: B, A's columns n0 on), and one share of A's rows,
// walked in 128-row tiles of slabs; a slab is CH chains of MMAs (16 rows of
// two k8 steps for tf32, 32 rows of two k16 steps for bf16), each into its
// own outputs from zero.  The chassis is K3's (project_wgmma.cuh):
//
//   copies  Thread 0 issues each slab's copies into a ring of slots on
//     mbarriers: one bulk copy where an operand's block spans all its
//     columns and its slab is contiguous (any row width: K 82, 76, 22),
//     TMA boxes where it spans part of them (128-byte rows, the
//     128-byte swizzle for A and for a bf16 B), one bulk copy of the
//     slab's whole rows where f32 rows are not 16-byte aligned and they
//     fit a slot (`whole`: K 166, both sides read from it), element by
//     element by all threads where none can go (a base not 16-byte
//     aligned, a ragged last slab).  A slot is refilled after the slab's
//     barrier, or (`early`, a block whose m side spans all of A) beside the
//     next slab's MMAs, where thread 0 then delays no MMA of its warpgroup.
//   A from registers, B split once a CTA  A's fragments come from the raw
//     slot (f32: split into tf32 hi and lo in registers; bf16: ldmatrix
//     .trans).  TF32 wgmma reads its shared-memory operand K-major and B is
//     MN-major in memory, so each f32 slab of B is split once a CTA, a slab
//     ahead and beside the MMAs, into two buffers of tf32 hi and lo planes
//     of K-major core matrices; bf16 B is read straight from its swizzled
//     boxes through the transpose bit.
//   the upper blocks  Only the blocks holding an entry r <= c are
//     launched: block (mi, ni) for ni >= mi BM / N.  Where B's columns lie
//     within the m side's (n0 >= m0, n0 + N <= m0 + BM; for bf16 n0 - m0 a
//     multiple of a 64-column box) B is not copied: it is split from A's
//     slab (f32) or read from A's boxes (bf16).  The output mirrors the
//     upper triangle, so G is exactly symmetric.
//   concurrency  Each slab's MMAs are waited for (wgmma.wait_group 0)
//     before their sums are added and the next A fragments loaded.  The
//     latency between a slab's last MMA and the next slab's first is hidden
//     by CH = 2 independent chains a slab where a thread's registers hold
//     them (K3's rule), or by two CTAs an SM (DUAL_SUMS: the f64 sums in
//     shared memory, one chain, at most 128 registers a thread).  Two slabs'
//     MMAs in flight in one warpgroup (wait_group 1, two sets of outputs)
//     do not survive ptxas here: with A in registers it serializes the MMAs
//     (C7513) and crashed; with both operands from shared memory it injects
//     a wait before each read of the older outputs (C7517) and the extra
//     shared-memory traffic of A's planes made it slower still.
//   one launch at small M  With one row share (M within one wave of
//     tiles: the DMDc stacks, the CholQR leaves) each CTA writes its block
//     of G in f32 straight from its f64 sums, mirrored: no scratch and no
//     atb_reduce.  (float) of the f64 sum, as
//     atb_reduce rounds a one-share sum: the two routes agree bit for bit.
//     A share's slabs past M are not walked.
//
// Sums, as every row-share kernel: each chain's MMAs run from zero, small
// terms first (the tensor core rounds its own sums toward zero), and their
// sum is added into f32 accumulators rounded to nearest, the chains in row
// order; every accumulator goes into an f64 sum every 128 rows, the folds
// staggered over a tile's slabs (K5's scheme: slab q of each tile folds the
// accumulators i with i % SPT == q), so each sums exactly 128 rows in f32
// between folds.  Each CTA writes its f64 block once into its share's
// slice of the scratch; atb_tc::atb_reduce sums the shares in a fixed
// order: the output is identical from run to run.  No atomics.
//
// What bounds it on an H100: 3 M K (K + 1) TF32 operations for f32 (1 for
// bf16; the upper half of G) against M K element reads once.
// What the card reads is a slab's fixed cost (its wait, adds, fold, split,
// barrier and copies) beside MMAs that are a few hundred clocks of tensor
// work: scripts/torch_k4_phases.py's variants (PERF.md) drop one phase each.
//
// Blocks: the wrapper's table (ops/atb.py::gram_block) picks N, where the
// f64 sums live (SumsKind) and the early refill; atb.cu instantiates the
// widths and keeps, for the f32 Grams the table sends there,
// row_share_atb_tc.cuh's 128 x 128 mainloop.
// Ranges: any M and K; ragged edges masked (rows past M are zero in every
// slot; columns past K are zero in B's planes, or reach only rows or
// columns of G that are not written).

#pragma once

#include "project_wgmma.cuh"

namespace atbw {

using atb_tc::bf16;
using atb_tc::smem_u32;

constexpr int THREADS = 256;  // two warpgroups: the block's m side
constexpr int BM = 128;       // A's columns a block
constexpr int N_MAX = 88;     // widest block (its f64 sums in shared memory past 64)
constexpr int MAX_RING = 8;
constexpr int SMEM_CAP = 232448;

// Where a block's f64 sums live, and how many CTAs share an SM (Cfg's KIND):
// in registers (N <= 64), in shared memory (N 72-88), or in shared memory
// with two CTAs an SM (N <= 64; one chain a slab, at most 128 registers a
// thread and half the SM's shared memory a CTA).
enum SumsKind : int { REG_SUMS = 0, SMEM_SUMS = 1, DUAL_SUMS = 2 };

// T A's type; N the block's n; KIND a SumsKind.
template <typename T, int N, int KIND>
struct Cfg {
  static constexpr bool BF16 = sizeof(T) == 2;  // one bf16 pass
  static constexpr bool SSUMS = KIND != REG_SUMS;
  static constexpr int CTAS = KIND == DUAL_SUMS ? 2 : 1;  // CTAs an SM
  static constexpr int NACC = N / 2;         // f32 accumulators a thread: m64 x nN
  static constexpr int H = BF16 ? 32 : 16;   // rows of one MMA chain: two k16 / k8 steps
  static constexpr int SUMS = SSUMS ? NACC * THREADS * 8 : 0;
  // a CTA's shared memory: all of it, or half an SM's (each CTA's 1 KB of
  // the SM's 228 KB reserved)
  static constexpr int CAP = CTAS == 1 ? SMEM_CAP : (233472 - 2 * 1024) / 2;
  // B's tf32 planes (f32): a chain's hi plane (H x N words) and lo plane, in
  // two buffers; bf16 has none
  static constexpr int PLANE = BF16 ? 0 : H * N * 4;
  static constexpr int HALF = 2 * PLANE;  // a chain's planes
  // a slot of ch chains' rows: A's BM columns, B's N (bf16: boxes of 64
  // columns, the 128-byte swizzle; else raw, split); and the slots that fit
  // beside the planes and the sums
  static constexpr int slot_of(int ch) {
    return ch * H * BM * (int)sizeof(T) +
           (BF16 ? (N + 63) / 64 * ch * H * 128 : (ch * H * N * (int)sizeof(T) + 1023) / 1024 * 1024);
  }
  static constexpr int ring_of(int ch) {
    return (CAP - 1024 - 2 * ch * HALF - SUMS - MAX_RING * 8) / slot_of(ch);
  }
  // chains a slab, each into its own MMA outputs (K3's rule): two where a
  // thread's registers hold them beside the f32 sums, the f64 sums (unless
  // in shared memory) and the A fragments, and three slots still fit, with
  // one CTA an SM
  static constexpr int CH = CTAS == 1 && 2 * NACC + NACC + (SSUMS ? 0 : 2 * NACC) + (BF16 ? 16 : 32) <= 200 &&
                                    ring_of(2) >= 3
                                ? 2
                                : 1;
  static constexpr int R = CH * H;            // rows a slab
  static constexpr int SPT = atb_tc::MT / R;  // slabs a 128-row tile
  static constexpr int A_BYTES = R * BM * (int)sizeof(T);  // 8 or 16 KB
  static constexpr int NB = BF16 ? (N + 63) / 64 : 0;     // bf16 B's boxes
  static constexpr int SLOT = slot_of(CH);
  static constexpr int BUF = CH * HALF;  // a slab's planes
  static constexpr int PLANES = 2 * BUF;
  static constexpr int RING = ring_of(CH) < MAX_RING ? ring_of(CH) : MAX_RING;
  static constexpr int SMEM = 1024 + RING * SLOT + PLANES + SUMS + RING * 8;
  static constexpr int BOXC = 128 / (int)sizeof(T);  // columns of one of A's swizzled boxes
  static constexpr int BOXB = R * 128;                // bytes of one
  static_assert(N % 8 == 0 && N >= 8 && N <= N_MAX, "a wgmma width of the table");
  static_assert(KIND == SMEM_SUMS || N <= 64, "registers hold the f64 sums, or two CTAs an SM, to N 64");
  static_assert(RING >= (CTAS == 2 ? 2 : 3), "slots in flight");
  static_assert(SMEM <= CAP, "shared memory of one CTA");
};

struct Params {
  const void* a;   // M x K
  double* part;    // n_share x K x K f64; null: `out` written from the f64 sums
  float* out;      // G, K x K
  long long m;     // rows of A
  int k;           // A's columns
  int mode_a;      // k3::Mode of the m side's slabs
  int mode_b;      // and of the n side's, where they are copied
  int lda;         // A's raw row stride in a slot (elements), unless a_swz
  int ldb;         // B's (f32), unless bf16 (swizzled boxes)
  int a_swz;       // A's part of a slot holds swizzled boxes of 128-byte rows
  int whole;       // a slot holds the slab's whole rows (lda = K): A's columns
                   // m0 on and B's n0 on are read from them
  int n_share;
  int nbn;         // blocks along G's columns
  int early;       // refill a slab's slot beside the next slab's MMAs, not after its barrier
};

// Block (mi, ni) of CTA idx: the blocks ni >= mi BM / N (those holding an
// entry r <= c) in row-major order.
template <int N>
__device__ __forceinline__ void block_of(int idx, int nbn, int& mi, int& ni) {
  mi = 0;
  while (idx >= nbn - mi * BM / N) {
    idx -= nbn - mi * BM / N;
    ++mi;
  }
  ni = mi * BM / N + idx;
}

// Blocks of the launch: those holding an entry r <= c.
template <int N>
inline long long block_count(int k) {
  const long long nbm = (k + BM - 1) / BM, nbn = (k + N - 1) / N;
  long long n = 0;
  for (long long i = 0; i < nbm; ++i) n += nbn - i * BM / N;
  return n;
}

template <typename T, int N, int KIND>
__global__ void __launch_bounds__(THREADS, Cfg<T, N, KIND>::CTAS)
    atb_wgmma(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
              const Params p) {
  using C = Cfg<T, N, KIND>;
  constexpr int NACC = C::NACC;
  constexpr int CH = C::CH;
  constexpr bool SSUMS = C::SSUMS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* planes = ring + C::RING * C::SLOT;
  double* sums = reinterpret_cast<double*>(planes + C::PLANES);  // SSUMS: [NACC][THREADS]
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + C::PLANES + C::SUMS);

  int mi, ni;
  block_of<N>((int)blockIdx.x, p.nbn, mi, ni);
  const int m0 = mi * BM;
  const int n0 = ni * N;
  // B's columns within the m side's (or, whole, within the slab's rows):
  // B split from A's slab (f32) or read from its boxes (bf16), boff columns
  // on (whole: negative where n0 < m0); else not, and copied
  const bool b_copy = !p.whole && !(n0 >= m0 && n0 + N <= m0 + BM && (!C::BF16 || (n0 - m0) % 64 == 0));
  const int boff = n0 - m0;
  const int share = blockIdx.y;
  const long long n_tiles = (p.m + atb_tc::MT - 1) / atb_tc::MT;
  const long long my_tiles = share < n_tiles ? (n_tiles - share + p.n_share - 1) / p.n_share : 0;
  // slabs of the share's tiles that hold rows (< 2^31 for M < 2^34)
  const long long last_rows = p.m - (share + (my_tiles - 1) * p.n_share) * atb_tc::MT;
  const int n_slabs =
      my_tiles == 0 ? 0
                    : (int)((my_tiles - 1) * C::SPT +
                            (last_rows < atb_tc::MT ? (last_rows + C::R - 1) / C::R : C::SPT));
  // first row of slab s of this share: tile share + (s / SPT) n_share
  auto rows = [&](int s) {
    return (share + (long long)(s / C::SPT) * p.n_share) * atb_tc::MT + (s % C::SPT) * C::R;
  };

  const int ctid = threadIdx.x;
  if (ctid == 0) {
    for (int i = 0; i < C::RING; ++i) mm_tc::mbar_init(smem_u32(full + i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  using U = k3::Bits<T>;
  const U* src = static_cast<const U*>(p.a);
  // byte offset in a slot of A's element (k, m) of the block
  const int acol = p.whole ? m0 : 0;  // the block's first column in a raw slot
  auto a_off = [&](int k, int m) {
    return p.a_swz ? (m / C::BOXC) * C::BOXB + mm_tc::swz(k, (m % C::BOXC) * (int)sizeof(T))
                   : (k * p.lda + acol + m) * (int)sizeof(T);
  };
  // ELEM: rows r0 .. r0 + R - 1 of the block's columns (whole: of all
  // columns) into the slot's layout, zero past M and the columns
  auto fill_a = [&](unsigned char* st, long long r0) {
    const int w = p.a_swz ? BM : p.lda;
    for (int idx = ctid; idx < C::R * w; idx += THREADS) {
      const int k = idx / w, c = idx % w;
      const long long gr = r0 + k;
      const int gc = m0 - acol + c;
      *reinterpret_cast<U*>(st + a_off(k, c - acol)) = gr < p.m && gc < p.k ? src[gr * p.k + gc] : U(0);
    }
  };
  auto fill_b = [&](unsigned char* st, long long r0) {
    const int w = C::BF16 ? C::NB * 64 : p.ldb;
    for (int idx = ctid; idx < C::R * w; idx += THREADS) {
      const int k = idx / w, c = idx % w;
      const long long gr = r0 + k;
      const int gc = n0 + c;
      const U v = gr < p.m && gc < p.k ? src[gr * p.k + gc] : U(0);
      const int off = C::BF16 ? (c / 64) * C::R * 128 + mm_tc::swz(k, (c % 64) * 2)
                              : (k * p.ldb + c) * (int)sizeof(T);
      *reinterpret_cast<U*>(st + off) = v;
    }
  };
  // the bytes of one slab of each side by bulk copy or TMA, and of one of
  // A's rows (a bulk copy's); B's none where it is the m side's
  const long long a_row = (long long)p.k * sizeof(T);
  uint32_t a_bytes = (uint32_t)(C::R * a_row);
  if (p.mode_a != k3::BULK) {
    a_bytes = 0;
    for (int b = 0; b < BM / C::BOXC; ++b) a_bytes += m0 + b * C::BOXC < p.k ? C::BOXB : 0;
  }
  uint32_t b_bytes = (uint32_t)(C::R * (p.mode_b == k3::BULK ? a_row : N * (int)sizeof(T)));
  if (C::BF16) {
    b_bytes = 0;
    for (int b = 0; b < C::NB; ++b) b_bytes += n0 + 64 * b < p.k ? C::R * 128 : 0;
  }
  // which of slab s's operands come element by element (ELEM, or a bulk
  // copy's ragged last slab)
  auto elem_parts = [&](int s, bool& a_elem, bool& b_elem) {
    const bool whole = rows(s) + C::R <= p.m;
    a_elem = p.mode_a == k3::ELEM || (p.mode_a == k3::BULK && !whole);
    b_elem = b_copy && (p.mode_b == k3::ELEM || (p.mode_b == k3::BULK && !whole));
  };
  // thread 0: slab s's copies into slot `slot`, the bytes announced on its
  // barrier (which completes it where both parts came element by element)
  auto issue_copies = [&](int s, int slot, bool a_elem, bool b_elem) {
    unsigned char* st = ring + slot * C::SLOT;
    const long long r0 = rows(s);
    const uint32_t bar = smem_u32(full + slot);
    mm_tc::mbar_expect_tx(bar, (a_elem ? 0u : a_bytes) + (b_copy && !b_elem ? b_bytes : 0u));
    if (!a_elem) {
      if (p.mode_a == k3::BULK) {
        mm_tc::bulk_load(smem_u32(st), static_cast<const unsigned char*>(p.a) + r0 * a_row, a_bytes, bar);
      } else {
#pragma unroll
        for (int b = 0; b < BM / C::BOXC; ++b) {
          if (m0 + b * C::BOXC < p.k) {
            mm_tc::tma_load(smem_u32(st + b * C::BOXB), &amap, m0 + b * C::BOXC, (int)r0, bar);
          }
        }
      }
    }
    if (b_copy && !b_elem) {
      if (p.mode_b == k3::BULK) {
        mm_tc::bulk_load(smem_u32(st + C::A_BYTES), static_cast<const unsigned char*>(p.a) + r0 * a_row,
                         b_bytes, bar);
      } else if (C::BF16) {
#pragma unroll
        for (int b = 0; b < C::NB; ++b) {
          if (n0 + 64 * b < p.k) {
            mm_tc::tma_load(smem_u32(st + C::A_BYTES + b * C::R * 128), &bmap, n0 + 64 * b, (int)r0, bar);
          }
        }
      } else {
        mm_tc::tma_load(smem_u32(st + C::A_BYTES), &bmap, n0, (int)r0, bar);
      }
    }
  };
  // slab s into slot `slot`: the ELEM parts by all threads, then thread 0
  // arrives with the bytes of the copies and issues them
  auto produce = [&](int s, int slot) {
    bool a_elem, b_elem;
    elem_parts(s, a_elem, b_elem);
    unsigned char* st = ring + slot * C::SLOT;
    if (a_elem) fill_a(st, rows(s));
    if (b_elem) fill_b(st + C::A_BYTES, rows(s));
    if (a_elem || b_elem) {
      atb_tc::fence_proxy_async();
      k5::consumer_sync();
    }
    if (ctid == 0) issue_copies(s, slot, a_elem, b_elem);
  };

  const int cw = ctid >> 5;
  const int lane = ctid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (cw >> 2) * 64 + (cw & 3) * 16;  // the warp's 16 rows of the block's m side
  // this thread's A fragments at the slab's first k-step: f32, register i:
  // row g (+8 for odd i) of the warp's 16, k = t (+4 for i >= 2); bf16: the
  // ldmatrix lane address, row lane % 8 of core matrix lane / 8.  k-step j
  // of the slab (chain j / 2) is j qstep bytes on (the swizzle repeats
  // every 8 rows)
  int offa[C::BF16 ? 1 : 4];
  if constexpr (C::BF16) {
    const int j = lane >> 3;
    offa[0] = a_off((j >> 1) * 8 + (lane & 7), row0 + (j & 1) * 8);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) offa[i] = a_off(t + 4 * (i >> 1), row0 + g + 8 * (i & 1));
  }
  const int qstep = C::H / 2 * (p.a_swz ? 128 : p.lda * (int)sizeof(T));

  auto wait_full = [&](int s) {
    mm_tc::mbar_wait(smem_u32(full + s % C::RING), (uint32_t)((s / C::RING) & 1));
  };
  // B's f32 slab s into plane buffer s % 2, once it has landed (bf16: the
  // wait alone): a unit is the four k of one n that share 16 bytes of a
  // K-major core matrix of its chain's planes, (n / 8) (H / 4) + (k % H) / 4
  // at word (n % 8) 4 + k % 4 (lanes on neighbouring n: one raw row, whole
  // core-matrix rows); from B's part of the slot, or from A's columns boff
  // on; zero past B's width
  auto split = [&](int s) {
    wait_full(s);
    if constexpr (!C::BF16) {
      const unsigned char* st = ring + (s % C::RING) * C::SLOT;
      unsigned char* pl = planes + (s & 1) * C::BUF;
      constexpr int UNITS = C::R * N / 4;
#pragma unroll
      for (int i = 0; i < (UNITS + THREADS - 1) / THREADS; ++i) {
        const int u = i * THREADS + ctid;
        if (UNITS % THREADS != 0 && u >= UNITS) break;
        const int n = u % N;
        const int kb = u / N;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * kb + e;
          if (!b_copy) {
            v[e] = n0 + n < p.k ? *reinterpret_cast<const float*>(st + a_off(k, boff + n)) : 0.f;
          } else {
            v[e] = n < p.ldb ? reinterpret_cast<const float*>(st + C::A_BYTES)[k * p.ldb + n] : 0.f;
          }
        }
        uint4 h, l;
        atb_tc::split_tf32(v[0], h.x, l.x);
        atb_tc::split_tf32(v[1], h.y, l.y);
        atb_tc::split_tf32(v[2], h.z, l.z);
        atb_tc::split_tf32(v[3], h.w, l.w);
        const int w = ((n >> 3) * (C::H / 4) + kb % (C::H / 4)) * 32 + (n & 7) * 4;
        unsigned char* hp = pl + kb / (C::H / 4) * C::HALF + w * 4;
        *reinterpret_cast<uint4*>(hp) = h;
        *reinterpret_cast<uint4*>(hp + C::PLANE) = l;
      }
    }
  };

  float acc[NACC], d[CH][NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    acc[i] = 0.f;
#pragma unroll
    for (int h = 0; h < CH; ++h) d[h][i] = 0.f;
  }
  double rsum[SSUMS ? 1 : NACC];
  if constexpr (SSUMS) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) sums[i * THREADS + ctid] = 0.0;
  } else {
#pragma unroll
    for (int i = 0; i < NACC; ++i) rsum[i] = 0.0;
  }
  // accumulators i % SPT == Q into the f64 sums and from zero: slab Q of
  // each tile folds them, so each sums exactly SPT slabs (128 rows) in f32
  // between folds
  auto fold = [&](auto qc) {
    constexpr int Q = decltype(qc)::value;
#pragma unroll
    for (int i = Q; i < NACC; i += C::SPT) {
      if constexpr (SSUMS) {
        sums[i * THREADS + ctid] += (double)acc[i];
      } else {
        rsum[i] += (double)acc[i];
      }
      acc[i] = 0.f;
    }
  };
  auto fold_group = [&](int q) {
    k5::each_index([&](auto qc) {
      if (decltype(qc)::value == q) fold(qc);
    }, std::make_integer_sequence<int, C::SPT>{});
  };

  // the ring's first slabs; then slot s % RING is refilled with slab s +
  // RING once every thread is past slab s's barrier: right after it, or
  // (early) beside the MMAs of slab s + 1
  for (int s = 0; s < C::RING && s < n_slabs; ++s) produce(s, s);
  if (n_slabs > 0) split(0);
  atb_tc::fence_proxy_async();  // the planes, to wgmma's reads
  k5::consumer_sync();
  int in_tile = 0;  // s % SPT
  const uint32_t plane0 = smem_u32(planes);
  // slab s: A's fragments from its slot, its CH chains of MMAs, and beside
  // them the fold of group s % SPT and slab s + 1's split
  for (int s = 0; s < n_slabs; ++s) {
    const unsigned char* sa = ring + (s % C::RING) * C::SLOT;
    uint32_t ah[CH][2][4], al[CH][2][4];
#pragma unroll
    for (int h = 0; h < CH; ++h) atb_tc::hold(d[h]);
    if constexpr (C::BF16) {
#pragma unroll
      for (int j = 0; j < 2 * CH; ++j) {
        uint32_t(&a)[4] = ah[j >> 1][j & 1];
        atb_tc::ldsm_x4_trans(smem_u32(sa + offa[0] + j * qstep), a[0], a[1], a[2], a[3]);
      }
      const uint32_t pb = smem_u32(b_copy ? sa + C::A_BYTES : sa + (boff / 64) * C::BOXB);
      k3::mma_slab(d, ah, pb, C::R * 128);
    } else {
#pragma unroll
      for (int j = 0; j < 2 * CH; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          atb_tc::split_tf32(*reinterpret_cast<const float*>(sa + offa[i] + j * qstep), ah[j >> 1][j & 1][i],
                             al[j >> 1][j & 1][i]);
        }
      }
      k3::mma_slab<false>(d, ah, al, plane0 + (s & 1) * C::BUF, C::HALF, C::PLANE);
    }
    // early: slab s - 1's slot refilled by thread 0 beside the MMAs, unless
    // a part comes element by element (then after the barrier below)
    bool early_elem = false;
    if (p.early && s >= 1 && s - 1 + C::RING < n_slabs) {
      bool a_elem, b_elem;
      elem_parts(s - 1 + C::RING, a_elem, b_elem);
      early_elem = a_elem || b_elem;
      if (!early_elem && ctid == 0) {
        issue_copies(s - 1 + C::RING, (s - 1) % C::RING, false, false);  // the copies, beside the MMAs
      }
    }
    fold_group(in_tile);  // the staggered fold
    if (s + 1 < n_slabs) split(s + 1);  // the split
    atb_tc::fence_proxy_async();
    atb_tc::wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < CH; ++h) {
      atb_tc::hold(d[h]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        atb_tc::hold(ah[h][q]);
        if constexpr (!C::BF16) atb_tc::hold(al[h][q]);
      }
    }
#pragma unroll
    for (int h = 0; h < CH; ++h) {  // the chains in row order
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += d[h][i];
    }
    if (++in_tile == C::SPT) in_tile = 0;
    k5::consumer_sync();  // slab s + 1 split; slab s's slot and planes done with
    if (!p.early && s + C::RING < n_slabs) produce(s + C::RING, s % C::RING);  // the copies
    if (early_elem) produce(s - 1 + C::RING, (s - 1) % C::RING);
  }
  k5::each_index(fold, std::make_integer_sequence<int, C::SPT>{});  // the last folds

  // accumulator i: row g (+8 for i % 4 >= 2) of the warp's 16 on the m
  // side, column 8 (i / 4) + 2 t + i % 2 on the n side
  auto sum_of = [&](int i) {
    if constexpr (SSUMS) {
      return sums[i * THREADS + ctid];
    } else {
      return rsum[i];
    }
  };
  double* dst = p.part == nullptr ? nullptr : p.part + (size_t)share * p.k * p.k;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int r = m0 + row0 + g + ((i & 3) >> 1) * 8;
    const int c = n0 + (i >> 2) * 8 + 2 * t + (i & 1);
    if (r >= p.k || c >= p.k) continue;
    const double v = sum_of(i);
    const size_t at = (size_t)r * p.k + c;
    if (dst != nullptr) {
      dst[at] = v;  // atb_reduce reads (min, max) of an upper entry
    } else if (r <= c) {
      p.out[at] = (float)v;
      p.out[(size_t)c * p.k + r] = (float)v;
    }
  }
}

// ------------------------------------------------------------ host side

// How each side's slabs come (k3::project_modes' rule), into p; bf16 A
// always in swizzled boxes (a block's B may be read from them).
template <typename T, int N, int KIND>
void modes(Params& p) {
  using C = Cfg<T, N, KIND>;
  const bool tma_rows = p.m <= INT_MAX;
  const bool aligned = reinterpret_cast<uintptr_t>(p.a) % 16 == 0;
  const bool rows16 = (p.k * (long long)sizeof(T)) % 16 == 0;
  const int round8 = (p.k + 7) / 8 * 8;
  // f32 rows past one block that are not 16-byte aligned (K 166): a slab
  // of whole rows is one contiguous span, R K 4 bytes (a multiple of 16),
  // copied whole where it fits a slot, the reads of a block's last columns
  // (up to BM - 1 past K) included
  p.whole = !C::BF16 && p.k > BM && aligned && !rows16 &&
            ((long long)C::R * p.k + BM) * (long long)sizeof(T) <= C::SLOT;
  if (p.k <= BM && !C::BF16) {  // one block spans A: slabs are contiguous spans
    p.a_swz = 0;
    p.mode_a = aligned ? k3::BULK : k3::ELEM;
    p.lda = p.mode_a == k3::BULK ? p.k : round8;
  } else if (p.whole) {
    p.a_swz = 0;
    p.lda = p.k;
    p.mode_a = k3::BULK;
  } else {
    p.a_swz = 1;
    p.lda = BM;
    p.mode_a = aligned && rows16 && tma_rows ? k3::TMA : k3::ELEM;
  }
  if (C::BF16) {  // always boxes of 64 columns: TMA, or ELEM into their layout
    p.ldb = 0;
    p.mode_b = aligned && rows16 && tma_rows ? k3::TMA : k3::ELEM;
  } else if (p.k <= N) {
    p.mode_b = aligned ? k3::BULK : k3::ELEM;
    p.ldb = p.mode_b == k3::BULK ? p.k : round8;
  } else if (p.whole) {  // read from the slab's whole rows, not copied
    p.ldb = p.k;
    p.mode_b = k3::BULK;
  } else {
    p.ldb = N;
    p.mode_b = aligned && rows16 && tma_rows ? k3::TMA : k3::ELEM;
  }
}

// The dynamic shared memory of one instantiation, allowed once on each
// device (as mm_tc::allow_smem: not at every launch, where the call is host
// time beside a kernel of a few microseconds).
template <typename T, int N, int KIND>
static cudaError_t allow() {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ULL << dev;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(atb_wgmma<T, N, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<T, N, KIND>::SMEM);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// G (f32) = A^T A through upper blocks of N columns: the kernel, then
// atb_reduce where p.part is set (n_share K x K f64 slices), on `stream`;
// p's a, part, out, m, k, early and n_share set.  Returns a cudaError_t
// code.
template <typename T, int N, int KIND>
cudaError_t launch(Params p, cudaStream_t stream) {
  using C = Cfg<T, N, KIND>;
  const long long n_blocks = block_count<N>(p.k);
  if (p.m < 1 || p.k < 1 || p.n_share < 1 || p.n_share > 65535 || n_blocks > 0x7fffffffLL ||
      p.out == nullptr) {
    return cudaErrorInvalidValue;
  }
  p.nbn = (p.k + N - 1) / N;
  modes<T, N, KIND>(p);
  CUtensorMap amap{}, bmap{};
  cudaError_t err = cudaSuccess;
  if (p.mode_a == k3::TMA) err = k3::encode<T>(&amap, p.a, p.m, p.k, C::BOXC, C::R, true);
  if (err == cudaSuccess && p.mode_b == k3::TMA) {
    err = C::BF16 ? k3::encode<T>(&bmap, p.a, p.m, p.k, 64, C::R, true)
                  : k3::encode<T>(&bmap, p.a, p.m, p.k, N, C::R, false);
  }
  if (err == cudaSuccess) err = allow<T, N, KIND>();
  if (err != cudaSuccess) return err;
  atb_wgmma<T, N, KIND><<<dim3((unsigned)n_blocks, p.n_share), THREADS, C::SMEM, stream>>>(amap, bmap, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.part == nullptr) return err;
  const long long total = (long long)p.k * p.k;
  atb_tc::atb_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(p.part, p.out, p.n_share, p.k,
                                                                          p.k, 1);
  return cudaGetLastError();
}

// CTAs of the kernel that fit one SM at once, into *out.
template <typename T, int N, int KIND>
cudaError_t ctas_per_sm(int* out) {
  const cudaError_t err = allow<T, N, KIND>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, atb_wgmma<T, N, KIND>, THREADS,
                                                       Cfg<T, N, KIND>::SMEM);
}

}  // namespace atbw
