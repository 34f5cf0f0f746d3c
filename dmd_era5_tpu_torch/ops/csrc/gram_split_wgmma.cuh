// K5 on Hopper's warpgroup MMAs: the bf16-split Gram G = A^T A of a tall
// f32 panel A (M x K), G ~= H^T H + H^T L + (H^T L)^T with H = bf16(A)
// rounded to nearest and L = bf16(A - H) (L^T L dropped, as in the JAX
// kernel), summed in f64.  gram.cu launches it behind gram(a, "bf16_split").
//
// Work split, as the other row-share kernels (row_share_atb_tc.cuh): a CTA
// owns one upper block (bi <= bj, atb_tc::block_of) of G, BT x BT, and one
// share of the rows, which it walks in 128-row tiles; atb_reduce sums the
// shares in a fixed order and mirrors the upper triangle, so G is exactly
// symmetric and identical from run to run.  No atomics.
//
// A slab is 2,048 entries of one operand: 16 rows of 128 columns (BT 128) or
// 32 rows of 64 (BT 64).  Each slab of A_i (the block's rows) and of B_j (its
// columns) is split ONCE per CTA: a consumer thread takes one run of 8
// columns of one row of each, forms H and L, and stores each as one 16-byte
// row of an 8 x 8 core matrix of the slab's H and L planes, MN-major, the
// layout wgmma reads (8 lanes fill one core matrix: no bank conflict).  A
// diagonal block (bi = bj) loads and splits B's slab alone, and its A
// operand is B's planes.
//
// MMAs: two consumer warpgroups, wgmma m64nBTk16 bf16 into f32; A fragments
// from the planes by ldmatrix.trans, B by descriptor (the transpose bit).
// BT 128: warpgroup w owns rows 64 w .. 64 w + 63 of the block.  BT 64: both
// own its 64 rows, warpgroup w takes k16 step w of each slab, and their f64
// sums are added, in warpgroup order, as the block is written.  Each k16
// step's D starts from zero with the small terms, L_i^T H_j + H_i^T L_j, then
// + H_i^T H_j; acc += D in f32 rounded to nearest (the tensor core rounds its
// own sums toward zero), and acc is folded into f64 sums every 128 rows
// (an f32 sum over a CTA's rows loses G's noise floor at ERA5 size): slab q
// of each tile folds the q-th of SPT groups of a thread's accumulators, so
// every accumulator sums exactly 128 rows in f32 between two folds, and the
// folds are spread over the slabs, beside their MMAs.  The 64 f64 sums a
// thread of BT 128 live in shared memory (128 KB, each thread its own
// slots), the 32 of BT 64 in registers.  The planes are double-buffered: a
// slab's split runs while the MMAs of the one before it run.
//
// Loads, two instantiations:
//   TMA  rows and base 16-byte aligned (K % 4 == 0, M < 2^31): a producer
//        warpgroup (40 registers a thread by setmaxnreg; the consumers take
//        232) whose one thread copies each raw f32 slab by TMA -- boxes of 32
//        columns x the slab's rows, the 128-byte swizzle, zero-filled past M
//        and K, boxes wholly past K not copied -- into a ring of RING slots
//        on mbarriers; the consumers free a slot once they have split it.
//   REG  other rows (K 110, the sketch; K 97): no producer; each consumer
//        thread loads its runs of a slab into registers two slabs before it
//        splits them (8-byte loads where every row is 8-byte aligned, else
//        one entry at a time; zero past M and K), as the wgmma kernels'
//        register-staged loads (atb_tc::load_slab) do, and splits them
//        straight into the planes.
//
// gram.cu's note says what bounds the kernel in each regime and holds the
// table of block edges by K.

#pragma once

#include "matmul_tc.cuh"

namespace k5 {

using atb_tc::bf16;
using atb_tc::smem_u32;

constexpr int CONSUMERS = 256;      // two warpgroups
constexpr int PRODUCERS = 128;      // one warpgroup (TMA)
constexpr int SLAB_ENTRIES = 2048;  // of one operand: BT columns x 2048 / BT rows
constexpr int PRODUCER_REGS = 40;   // setmaxnreg: 128 x 40 + 256 x 232 <= 384 x 168
constexpr int CONSUMER_REGS = 232;

template <int BT, bool TMA>
struct Cfg {
  static constexpr int R = SLAB_ENTRIES / BT;  // rows a slab: 16 or 32
  static constexpr int SPT = atb_tc::MT / R;   // slabs a 128-row tile
  static constexpr int THREADS = TMA ? PRODUCERS + CONSUMERS : CONSUMERS;
  static constexpr int NACC = BT / 2;  // f32 accumulators a thread: m64 x nBT
  static constexpr bool SMEM_SUMS = BT == 128;
  static constexpr int SLAB = SLAB_ENTRIES * 4;   // an operand's raw slab, bytes
  static constexpr int BOX = R * 128;             // one TMA box: 32 columns x R rows
  static constexpr int PLANE = SLAB_ENTRIES * 2;  // one bf16 plane of a slab
  static constexpr int RING = TMA ? (BT == 128 ? 4 : 8) : 0;  // slots of A's and B's raw slabs
  static constexpr int RING_BYTES = RING * 2 * SLAB;
  static constexpr int PLANES_BYTES = 2 * 4 * PLANE;  // two buffers of B_H, B_L, A_H, A_L
  static constexpr int SUM_BYTES = SMEM_SUMS ? NACC * CONSUMERS * 8 : 0;
  static constexpr int SMEM = 1024 + RING_BYTES + PLANES_BYTES + SUM_BYTES + RING * 16;
  static_assert(BT == 128 || BT == 64, "the block edges of the table in gram.cu");
  static_assert(R / 16 == (BT == 128 ? 1 : 2), "one k16 step a slab and consumer warpgroup");
  static_assert(R / 8 * (BT / 8) * 8 == CONSUMERS, "one run of each operand a consumer thread");
  static_assert(SMEM_SUMS || NACC * CONSUMERS / 2 * 8 <= PLANES_BYTES,
                "BT 64: warpgroup 1's sums pass through the planes");
  static_assert(SMEM <= 232448, "shared memory of one CTA");
};

// d (+)= a b, 64 x 64: a a warp's 16 rows in registers (the m16n8k16
// fragment), b MN-major from a descriptor (transposed); d as 8 n8 tiles of
// the m16n8 accumulator layout.  The n128 one is atb_tc's.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
using atb_tc::wgmma_bf16;

// One k16 step of the split product from zero: L_i^T H_j, + H_i^T L_j, +
// H_i^T H_j.  ah, al: A's fragments; b_hi: B's H plane at the step, its L
// plane `plane` bytes on; lbo: bytes to the next core matrix along K.
template <int N>
__device__ __forceinline__ void mma_step(float (&d)[N], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], uint32_t b_hi, uint32_t plane,
                                         uint32_t lbo) {
  wgmma_bf16(d, al, mm_tc::smem_desc(b_hi, lbo, 128), 0);
  wgmma_bf16(d, ah, mm_tc::smem_desc(b_hi + plane, lbo, 128), 1);
  wgmma_bf16(d, ah, mm_tc::smem_desc(b_hi, lbo, 128), 1);
}

// H and L of a run of 8 entries, in pairs (the lower column in the low half).
__device__ __forceinline__ void split_run(const float (&v)[8], uint4& h, uint4& l) {
  atb_tc::split_bf16(v[0], v[1], h.x, l.x);
  atb_tc::split_bf16(v[2], v[3], h.y, l.y);
  atb_tc::split_bf16(v[4], v[5], h.z, l.z);
  atb_tc::split_bf16(v[6], v[7], h.w, l.w);
}

// Row gr, columns c .. c + 7 of a (m x k, row-major): 8-byte loads where
// every row is 8-byte aligned (vec8), else one entry at a time; zero past m
// and k.
__device__ __forceinline__ void load_run(const float* __restrict__ a, long long gr, int c,
                                         long long m, int k, bool vec8, float (&v)[8]) {
  const bool ok = gr < m;
  const float* p = a + gr * k + c;
  if (vec8) {
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const float2 u = ok && c + e < k ? __ldg(reinterpret_cast<const float2*>(p + e))
                                       : make_float2(0.f, 0.f);
      v[e] = u.x;
      v[e + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = ok && c + e < k ? __ldg(p + e) : 0.f;
  }
}

// f(std::integral_constant<int, Q>{}) for Q = 0, 1, ..., in order.
template <typename F, int... Q>
__device__ __forceinline__ void each_index(F&& f, std::integer_sequence<int, Q...>) {
  (f(std::integral_constant<int, Q>{}), ...);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// the two consumer warpgroups
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// amap: a's 2-D tensor map (TMA; boxes of 32 columns x Cfg::R rows, the
// 128-byte swizzle).  vec8: every row of a is 8-byte aligned (REG).
template <int BT, bool TMA>
__global__ void __launch_bounds__(Cfg<BT, TMA>::THREADS, 1)
    atb_split_wgmma(const __grid_constant__ CUtensorMap amap, const float* __restrict__ a,
                    double* __restrict__ part, long long m, int k, int n_share, int vec8) {
  using C = Cfg<BT, TMA>;
  constexpr int NACC = C::NACC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* planes = ring + C::RING_BYTES;
  double* sums = reinterpret_cast<double*>(planes + C::PLANES_BYTES);  // BT 128: [NACC][CONSUMERS]
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + C::PLANES_BYTES + C::SUM_BYTES);
  uint64_t* empty = full + C::RING;

  const int nbb = (k + BT - 1) / BT;
  int bi, bj;
  atb_tc::block_of(blockIdx.x, nbb, 1, bi, bj);
  const int a0 = bi * BT;
  const int b0 = bj * BT;
  const bool diag = bi == bj;
  const int share = blockIdx.y;
  const long long n_tiles = (m + atb_tc::MT - 1) / atb_tc::MT;
  const long long my_tiles = share < n_tiles ? (n_tiles - share + n_share - 1) / n_share : 0;
  const long long n_slabs = my_tiles * C::SPT;
  // first row of slab s of this share: tile share + (s / SPT) n_share
  auto rows = [&](long long s) {
    return (share + (s / C::SPT) * n_share) * atb_tc::MT + (s % C::SPT) * C::R;
  };

  if constexpr (TMA) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < C::RING; ++i) {
        mm_tc::mbar_init(smem_u32(full + i));
        mm_tc::mbar_init(smem_u32(empty + i));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < PRODUCERS) {  // the producer warpgroup
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
      if (threadIdx.x == 0) {
        // B's boxes of slab s, then A's (none on a diagonal block); a box
        // wholly past K is not copied: the consumers zero its runs
        auto slab_bytes = [&]() {
          uint32_t bytes = 0;
          for (int b = 0; b < BT / 32; ++b) {
            bytes += (b0 + 32 * b < k ? C::BOX : 0) + (!diag && a0 + 32 * b < k ? C::BOX : 0);
          }
          return bytes;
        };
        auto fetch = [&](long long s, unsigned char* st, uint32_t bar) {
          const int r0 = (int)rows(s);
          for (int b = 0; b < BT / 32; ++b) {
            if (b0 + 32 * b < k) mm_tc::tma_load(smem_u32(st + b * C::BOX), &amap, b0 + 32 * b, r0, bar);
            if (!diag && a0 + 32 * b < k) {
              mm_tc::tma_load(smem_u32(st + C::SLAB + b * C::BOX), &amap, a0 + 32 * b, r0, bar);
            }
          }
        };
        for (long long s = 0; s < n_slabs; ++s) {
          const int slot = (int)(s % C::RING);
          if (s >= C::RING) mm_tc::mbar_wait(smem_u32(empty + slot), (uint32_t)((s / C::RING - 1) & 1));
          const uint32_t bar = smem_u32(full + slot);
          mm_tc::mbar_expect_tx(bar, slab_bytes());
          fetch(s, ring + slot * 2 * C::SLAB, bar);
        }
      }
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  }

  const int ctid = threadIdx.x - (TMA ? PRODUCERS : 0);
  const int cw = ctid >> 5;
  const int lane = ctid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = cw >> 2;
  const int row0 = (BT == 128 ? wg * 64 : 0) + (cw & 3) * 16;  // the warp's 16 rows of the block
  const int kstep = BT == 128 ? 0 : wg;                        // its warpgroup's k16 step of a slab
  // this thread's run of each slab: row kr, columns 8 nb .. 8 nb + 7 of the
  // operand's BT; lanes 8 q .. 8 q + 7 fill one core matrix
  constexpr int KB = C::R / 8;
  const int kr = (ctid >> 3) % KB * 8 + (ctid & 7);
  const int nb = (ctid >> 3) / KB;
  const int run_off = ((kr >> 3) * (BT / 8) + nb) * 128 + (kr & 7) * 16;  // bytes into a plane

  // the run's H and L into plane pair `pair` (0: B's, 1: A's) of buffer buf
  auto store_run = [&](int buf, int pair, const float (&v)[8]) {
    uint4 h, l;
    split_run(v, h, l);
    unsigned char* p = planes + (buf * 4 + 2 * pair) * C::PLANE + run_off;
    *reinterpret_cast<uint4*>(p) = h;
    *reinterpret_cast<uint4*>(p + C::PLANE) = l;
  };
  // TMA: the run of an operand's raw slab (columns from c0) in the ring
  auto read_run = [&](const unsigned char* slab, int c0, float (&v)[8]) {
    if (c0 + 8 * nb >= k) {  // its box was not copied
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      return;
    }
    const unsigned char* box = slab + (nb >> 2) * C::BOX;
    const float4 x = *reinterpret_cast<const float4*>(box + mm_tc::swz(kr, (nb & 3) * 32));
    const float4 y = *reinterpret_cast<const float4*>(box + mm_tc::swz(kr, (nb & 3) * 32 + 16));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  };
  // REG: the runs of slab s (zero past the share's slabs) into registers;
  // slab s is held in vb[s % 2] (and va[s % 2]) from two slabs before its split
  float vb[2][8], va[2][8];
  auto fetch = [&](long long s, float (&b)[8], float (&av)[8]) {
    const long long gr = s < n_slabs ? rows(s) + kr : m;
    load_run(a, gr, b0 + 8 * nb, m, k, vec8, b);
    if (!diag) load_run(a, gr, a0 + 8 * nb, m, k, vec8, av);
  };
  // slab s into the planes of buffer s % 2 (P = s % 2, fixed at compile time
  // so that the held runs stay in registers)
  auto split_slab = [&](long long s, auto par) {
    constexpr int P = decltype(par)::value;
    if constexpr (TMA) {
      const int slot = (int)(s % C::RING);
      mm_tc::mbar_wait(smem_u32(full + slot), (uint32_t)((s / C::RING) & 1));
      const unsigned char* st = ring + slot * 2 * C::SLAB;
      float v[8];
      read_run(st, b0, v);
      store_run(P, 0, v);
      if (!diag) {
        read_run(st + C::SLAB, a0, v);
        store_run(P, 1, v);
      }
    } else {
      store_run(P, 0, vb[P]);
      if (!diag) store_run(P, 1, va[P]);
      fetch(s + 2, vb[P], va[P]);
    }
  };

  float acc[NACC], d[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = d[i] = 0.f;
  double rsum[C::SMEM_SUMS ? 1 : NACC];
  if constexpr (C::SMEM_SUMS) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) sums[i * CONSUMERS + ctid] = 0.0;
  } else {
#pragma unroll
    for (int i = 0; i < NACC; ++i) rsum[i] = 0.0;
  }
  // accumulators q G .. q G + G - 1 into the f64 sums (rounded to nearest),
  // and from zero: slab q of each tile folds group q, so each accumulator
  // sums exactly SPT slabs (128 rows) in f32 between folds, and the folds
  // run beside the MMAs, G a slab
  constexpr int G = NACC / C::SPT;
  auto fold = [&](auto qc) {
    constexpr int Q = decltype(qc)::value;
#pragma unroll
    for (int i = Q * G; i < Q * G + G; ++i) {
      if constexpr (C::SMEM_SUMS) {
        sums[i * CONSUMERS + ctid] += (double)acc[i];
      } else {
        rsum[i] += (double)acc[i];
      }
      acc[i] = 0.f;
    }
  };
  // the same for a group q known at run time (each group's accumulators
  // indexed at compile time, so that they stay in registers)
  auto fold_group = [&](int q) {
    each_index([&](auto qc) {
      if (decltype(qc)::value == q) fold(qc);
    }, std::make_integer_sequence<int, C::SPT>{});
  };

  // ldmatrix.trans: lane l addresses row l % 8 of core matrix (k block 2
  // kstep + l / 16, row block row0 / 8 + (l / 8) % 2) of A's planes
  const int j = lane >> 3;
  const uint32_t frag_off =
      ((2 * kstep + (j >> 1)) * (BT / 8) + (row0 >> 3) + (j & 1)) * 128 + (lane & 7) * 16;
  constexpr uint32_t LBO = BT / 8 * 128;   // to the next core matrix along K
  const uint32_t b_off = 2 * kstep * LBO;  // the warpgroup's k16 step in B's planes
  const uint32_t plane0 = smem_u32(planes);

  if constexpr (!TMA) {
    fetch(0, vb[0], va[0]);
    fetch(1, vb[1], va[1]);
  }
  if (n_slabs > 0) split_slab(0, std::integral_constant<int, 0>{});
  atb_tc::fence_proxy_async();  // the planes, to wgmma's reads
  consumer_sync();
  if constexpr (TMA) {
    if (ctid == 0 && n_slabs > 0) mbar_arrive(smem_u32(empty));
  }
  int in_tile = 0;  // s % SPT
  // slab s (buffer P = s % 2): its MMAs, and beside them the fold of
  // accumulator group s % SPT and slab s + 1's split
  auto slab = [&](long long s, auto par) {
    constexpr int P = decltype(par)::value;
    const uint32_t pb = plane0 + P * 4 * C::PLANE;     // B's H plane
    const uint32_t pa = diag ? pb : pb + 2 * C::PLANE;  // A's
    uint32_t ah[4], al[4];
    atb_tc::ldsm_x4_trans(pa + frag_off, ah[0], ah[1], ah[2], ah[3]);
    atb_tc::ldsm_x4_trans(pa + C::PLANE + frag_off, al[0], al[1], al[2], al[3]);
    atb_tc::hold(d);
    atb_tc::wgmma_fence();
    mma_step(d, ah, al, pb + b_off, C::PLANE, LBO);
    atb_tc::wgmma_commit();
    fold_group(in_tile);
    if (s + 1 < n_slabs) split_slab(s + 1, std::integral_constant<int, 1 - P>{});
    atb_tc::fence_proxy_async();
    atb_tc::wgmma_wait<0>();
    atb_tc::hold(d);
    atb_tc::hold(ah);
    atb_tc::hold(al);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += d[i];
    if (++in_tile == C::SPT) in_tile = 0;
    consumer_sync();  // slab s + 1 split; every MMA of slab s has completed
    if constexpr (TMA) {
      if (ctid == 0 && s + 1 < n_slabs) mbar_arrive(smem_u32(empty + (s + 1) % C::RING));
    }
  };
  for (long long s = 0; s < n_slabs; s += 2) {
    slab(s, std::integral_constant<int, 0>{});
    if (s + 1 < n_slabs) slab(s + 1, std::integral_constant<int, 1>{});
  }
  each_index(fold, std::make_integer_sequence<int, C::SPT>{});

  // accumulator i: row g (+8 for i % 4 >= 2) of the warp's 16, column 8 (i /
  // 4) + 2 t + i % 2.  BT 64: warpgroup 1's sums of the same entries pass
  // through the planes (every MMA has completed) to warpgroup 0, which adds
  // them to its own and writes.
  double* other = reinterpret_cast<double*>(planes);
  if constexpr (!C::SMEM_SUMS) {
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) other[i * (CONSUMERS / 2) + ctid - CONSUMERS / 2] = rsum[i];
    }
    consumer_sync();
    if (wg == 1) return;
  }
  double* dst = part + (size_t)share * k * k;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int r = a0 + row0 + g + ((i & 3) >> 1) * 8;
    const int c = b0 + (i >> 2) * 8 + 2 * t + (i & 1);
    double v;
    if constexpr (C::SMEM_SUMS) {
      v = sums[i * CONSUMERS + ctid];
    } else {
      v = rsum[i] + other[i * (CONSUMERS / 2) + ctid];
    }
    if (r < k && c < k) dst[(size_t)r * k + c] = v;
  }
}

// ------------------------------------------------------------ host side

// Whether a's row chunks go by TMA: base and rows 16-byte aligned, and every
// row index within TMA's 32-bit coordinates.
inline bool tma_rows(const float* a, long long m, int k) {
  return mm_tc::tma_ok<float>(a, k) && m <= 0x7fffffffLL;
}

// The kernel for block edge BT by TMA or not, and its shared memory,
// allowed once a call (as atb_tc::launch does).
template <int BT, bool TMA>
cudaError_t allow() {
  return cudaFuncSetAttribute(atb_split_wgmma<BT, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<BT, TMA>::SMEM);
}

// G (k x k, f32) of a (m x k, f32, row-major) over n_share row shares:
// the kernel, then atb_reduce, on `stream`; part holds n_share k^2 doubles.
// Returns a cudaError_t code.
template <int BT, bool TMA>
cudaError_t launch(const float* a, double* part, float* g, long long m, int k, int n_share,
                   cudaStream_t stream) {
  using C = Cfg<BT, TMA>;
  const long long nbb = (k + BT - 1) / BT;
  const long long n_blocks = nbb * (nbb + 1) / 2;
  if (m < 1 || k < 1 || n_share < 1 || n_share > 65535 || n_blocks > 0x7fffffffLL ||
      (TMA && !tma_rows(a, m, k))) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap map{};
  if constexpr (TMA) {
    const mm_tc::EncodeTiled encode = mm_tc::encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
    const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(float)};
    const cuuint32_t box[2] = {32, (cuuint32_t)C::R};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  cudaError_t err = allow<BT, TMA>();
  if (err != cudaSuccess) return err;
  atb_split_wgmma<BT, TMA><<<dim3((unsigned)n_blocks, n_share), C::THREADS, C::SMEM, stream>>>(
      map, a, part, m, k, n_share, atb_tc::row_copy_bytes(a, k) >= 8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)k * k;
  atb_tc::atb_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, g, n_share, k, k, 1);
  return cudaGetLastError();
}

// CTAs of the kernel for block edge BT that fit one SM at once, into *out
// (the TMA instantiation's; the other takes as many).
template <int BT>
cudaError_t ctas_per_sm(int* out) {
  const cudaError_t err = allow<BT, true>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, atb_split_wgmma<BT, true>,
                                                       Cfg<BT, true>::THREADS, Cfg<BT, true>::SMEM);
}

}  // namespace k5
