// K2 on Hopper's thread-block clusters: the first pass of the two-pass
// fallback, (Yc, rowsum, rowsumsq, G) from X (M x T) and a sketch W (T x N),
// at the widths past K1's (N 257-512) in bf16.
//
// Replaces dmd_era5_tpu/ops/matmul.py::_sketch_center_gram_kernel_1k and
// _sketch_center_gram_kernel (K2a and K2b, the whole-T and T-tiled Pallas
// kernels behind sketch_center_gram; one function, split by whether T fits
// a TPU's VMEM block).  It computes
//
//   Yc  = round_bf16(X W - (rs inv_t) colsum(W))    rs = row sums of X (f32)
//   rs, ss = row sums of x and of x * x, from the f32 values of X
//   G   = Yc^T Yc of the STORED Yc, f64-grade, exactly symmetric
//
// What bounds it on an H100: at the d = 3 Hankel pass (X 15,573,600 x 168,
// N 384) the bytes, X read once and Yc written once (17.2 GB, 5.13 ms at
// 3.35 TB/s), against 4.4 ms of bf16 tensor operations.  The Pallas kernel
// keeps G whole in VMEM and adds the Gram of each stored Yc tile into it;
// one Hopper CTA cannot hold it (590 KB in f32 at N 384), and its f64 sums,
// folded every 128 rows, fit the registers of 256 threads only as a 128 x
// 64 block.  Exchanging Yc between the CTAs that share G would move 2-3x Yc
// over the SM-to-SM network a pass (PERF.md has the budget; the exchange
// alone, scripts/torch_k2_phases.py's xchg2, adds 3 ms to the 13.4 ms sketch
// at d = 3 on an H100 80GB HBM3 at 700 W), so the pass is two kernels on
// clusters, each reading its operand from memory once per cluster:
//
//   1. sketch_cluster  A cluster of CL CTAs (CL = ceil(N / 64) <= 8) walks
//      128-row tiles of X; each 64-column chunk of a tile comes in by one
//      TMA multicast to every CTA of the cluster (its issuer rotates over
//      the ranks), and each CTA holds its 64 columns of W resident and
//      makes Yc's columns 64 rank on: bf16 wgmma m64n64k16, X's chunk read
//      by the MMA from its swizzled slot, a chunk's four k16 steps as two
//      chains of two from zero (32 columns of T each), their sums added
//      into f32 in T order, the row sums from the chunks in shared
//      memory, the tile centred, rounded and staged in the 128-byte
//      swizzle, and stored by one TMA store that runs beside the next
//      tile's MMAs.  The (M, 2) row statistics: where the call centres,
//      every rank sums them (each needs the row means) and rank 0 stores
//      them; else the ranks take the tiles in turn (the sums cost 4 of the
//      sketch's 20.6 ms when every rank made them).
//   2. gram_cluster  G's upper 128 x 64 blocks (m side two m64 warpgroups,
//      f64 sums in registers), a cluster of CTAs a group of blocks
//      (ops/k2.py::gram_plan); each 64-column box of a 64-row slab of Yc
//      that the group needs comes in once, by one TMA multicast to the CTAs
//      that read it, at the box's own offset in every CTA's slot, so an m
//      side and an n side meet in one copy.  Two MMA chains of 32 rows a
//      slab (two k16 steps each) from zero, added into f32, folded into f64
//      every 128 rows (staggered, as atb_wgmma.cuh); each row share's f64
//      block into scratch, then atb_tc::atb_reduce in share order, mirrored.
//      A cluster's padding CTA shadows its first block (receives and
//      computes it, writes nothing), so that it too waits on the copies.
//
// The copies ride a ring of slots on mbarriers (Feed): each job's copies are
// issued by one rank, in turn, for the whole cluster, once every CTA has
// released the slot; each CTA announces its bytes once its own previous use
// of the slot has landed.  One thread of a producer warpgroup (40 registers
// by setmaxnreg) does it.  setmaxnreg gives the two consumer warpgroups 232
// registers at run time, but ptxas compiles a 384-thread kernel to 168 a
// thread: so no MMA operand sits in registers (both come from shared-memory
// descriptors) and no branch sits among the MMAs (ptxas serializes them or
// injects waits: C7518, C7519).
//
// Sums: the sketch's MMA chains restart every 32 columns of T and add into
// f32; G as every row-share kernel (MMA sums restart every 32
// rows, f32 over 128 rows, then f64, shares reduced in a fixed order): the
// outputs are identical from run to run.  No atomics.
//
// Ranges (ops/k2.py::k2_block routes only these here; K1's sketch and G
// stages take the rest): bf16 X, W and Yc, N <= 64 x 8 and a multiple of 8,
// T a multiple of 8 (16-byte rows for the copies) with W's rows held beside
// two ring slots, a 16-byte aligned X, M < 2^31; ragged M and N masked by
// the copies (zero fill) and the stores (clipped).

#include <cooperative_groups.h>

#include "project_wgmma.cuh"

namespace k2c {

namespace cg = cooperative_groups;
using atb_tc::bf16;
using atb_tc::smem_u32;

constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = CONSUMERS + 128;   // and a producer warpgroup
constexpr int PRODUCER_REGS = 40;          // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int CONSUMER_REGS = 232;
constexpr int BM = 128;                    // rows of a sketch tile
constexpr int BN = 64;                     // Yc's columns a sketch CTA (one 128-byte box)
constexpr int CHUNK = BM * 128;            // a sketch slot: 128 rows x 64 bf16 of X
constexpr int STAGE = BM * BN * 2;         // a tile's staged Yc: 128 rows x 128 bytes
constexpr int GR = 64;                     // rows of a Gram slab: two chains of 32
constexpr int GBOX = GR * 128;             // a 64-column box of a Gram slab
constexpr int MAX_RING = 8;
constexpr int MAX_CLUSTER = 8;             // a portable cluster
constexpr int MAX_BOX = 8;                 // Yc's 64-column boxes: N <= 512
constexpr int MAX_PLAN = 32;
constexpr int SMEM_CAP = 232448;
constexpr int BARS = 2 * MAX_RING * 8;

// d (+)= a b, m64n64k16 bf16 summed in f32, both operands from shared
// memory: A's and B's descriptors, TA and TB their transpose bits (1: MN-
// major); d as 8 n8 tiles of the m16n8 accumulator layout; scale_d 0
// ignores d's old value.  No operand in registers: the consumers fit the
// 168 registers a thread of a 384-thread CTA.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" TC_REG8 "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
               : TC_OPS8
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// Descriptor of a K-major bf16 operand in the 128-byte swizzle as the TMA
// writes it (rows of 128 bytes, 8-row groups 1,024 bytes apart); a k16 step
// is 32 bytes on along the row.
__device__ __forceinline__ uint64_t sw128_k_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__host__ __device__ constexpr int kw_of(int t) { return (t + 63) / 64 * 64; }  // W's rows held

// Shared memory of a CTA (ops/k2.py mirrors both): the sketch's ring, W's
// column, two staged tiles of Yc, the row means and the barriers; the
// Gram's ring of slots of every box.
__host__ __device__ constexpr int sketch_smem(int t, int ring) {
  return 1024 + ring * CHUNK + kw_of(t) * BN * 2 + 2 * STAGE + BM * 4 + BARS;
}
__host__ __device__ constexpr int gram_smem(int n, int ring) {
  return 1024 + ring * ((n + 63) / 64) * GBOX + BARS;
}

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival on the barrier at `bar` of this CTA's shared memory, in CTA
// `rank` of the cluster.
__device__ __forceinline__ void arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
// Box (c0, c1) of the map into shared memory at dst of every CTA in `mask`,
// each completing on its own barrier at bar.
__device__ __forceinline__ void tma_multicast(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                              uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}
// Shared memory at src into box (c0, c1) of the map.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0, int c1, uint32_t src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Until at most N bulk groups still read their shared memory (.read), or
// still write (the last wait).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// This warpgroup is done with slot `s` (each warp's reads of it done): one
// arrival on the slot's empty barrier in CTA `issuer` of the cluster, the
// one that copies the slot's next use.
__device__ __forceinline__ void release(const uint64_t* empty, int s, int issuer, int tid) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (tid >> 7)) : "memory");
  if ((tid & 127) == 0) arrive_at(smem_u32(empty + s), (uint32_t)issuer);
}

// The producer's side of a ring whose jobs a cluster shares: job k goes
// into slot k % ring of every CTA, copied for all of them by rank k % cl.
// Each CTA announces job k's bytes on its own full barrier once its own
// previous use of the slot has landed; the copying rank also waits until
// every CTA released that use (each consumer warpgroup, done with job k,
// arrives on the empty barrier of the CTA that copies job k + ring).  One
// thread of a warpgroup that does nothing else: issued by a consumer
// thread, the copies held up its warpgroup's MMAs and the CTA's barriers
// (the sketch at d = 3: 25.8 ms, its thread 0 ~1,250 cycles a chunk in
// them).  Positions are kept by increments: a 64-bit division a job cost
// more than the job's MMAs (45.5 ms).
struct Feed {
  const uint64_t* full;
  const uint64_t* empty;
  int ring;
  int cl;
  int rank;

  // copy(slot) issues this rank's next job (they come in order)
  template <typename Copy>
  __device__ void run(long long jobs, uint32_t bytes, Copy&& copy) const {
    int slot = 0, turn = 0;
    uint32_t phase = 0, empty_phase = 0;  // empty_phase bit s: the parity of this CTA's next wait
    for (long long k = 0; k < jobs; ++k) {
      if (k >= ring) mm_tc::mbar_wait(smem_u32(full + slot), phase ^ 1u);
      mm_tc::mbar_expect_tx(smem_u32(full + slot), bytes);  // copy
      if (turn == rank) {
        if (k >= ring) {
          mm_tc::mbar_wait(smem_u32(empty + slot), (empty_phase >> slot) & 1u);
          empty_phase ^= 1u << slot;
        }
        copy(slot);
      }
      if (++turn == cl) turn = 0;
      if (++slot == ring) {
        slot = 0;
        phase ^= 1u;
      }
    }
  }
};

// The warpgroups' registers: the producer's given up to the consumers'.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}
// The 256 consumer threads (the producer warpgroup takes no part).
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }

// A consumer's position in the ring: the job's slot, the parity of its use
// of the slot, and the rank that copies the slot's next use.
struct Pos {
  int slot;
  uint32_t phase;
  int next_issuer;
  __device__ __forceinline__ void step(int ring, int cl) {
    if (++slot == ring) {
      slot = 0;
      phase ^= 1u;
    }
    if (++next_issuer == cl) next_issuer = 0;
  }
};

// ------------------------------------------------------------ the sketch

struct SketchArgs {
  const bf16* w;       // T x N, row-major
  const float* colw;   // N: column sums of W in f32
  float* stats;        // M x 2: rs and ss, written by rank 0
  float inv_t;         // 1 / t_valid, 0 without centring
  long long m;
  int t;
  int n;
  int ring;            // X's chunk slots
};

__global__ void __launch_bounds__(THREADS, 1)
    sketch_cluster(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
                   const SketchArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kw = kw_of(a.t);
  unsigned char* planes = ring + a.ring * CHUNK;                 // W's 64 columns, bf16
  unsigned char* staged = planes + kw * BN * 2;                  // two tiles of Yc, swizzled
  float* mu = reinterpret_cast<float*>(staged + 2 * STAGE);      // the tile's row means
  uint64_t* full = reinterpret_cast<uint64_t*>(mu + BM);
  uint64_t* empty = full + MAX_RING;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const long long cid = blockIdx.x / cl;  // this cluster
  const long long n_cl = gridDim.x / cl;
  const int n0 = rank * BN;
  const long long tiles = (a.m + BM - 1) / BM;
  const long long my_tiles = cid < tiles ? (tiles - 1 - cid) / n_cl + 1 : 0;
  const int cpt = (a.t + 63) / 64;  // chunks a tile
  const long long jobs = my_tiles * cpt;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < a.ring; ++s) {
      mbar_init(smem_u32(full + s), 1);            // the producer's arrival, and the bytes
      mbar_init(smem_u32(empty + s), 2 * cl);      // each consumer warpgroup of the cluster, once a use
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    // W's columns n0 on, rows [0, kw), zero past T and N, in MN-major core
    // matrices of 8 k x 16 bytes (matmul_tc.cuh's bf16 layout): runs of 8 n
    // of one k at element ((kk / 8) (BN / 8) + nn / 8) 64 + (kk % 8) 8
    const unsigned short* wh = reinterpret_cast<const unsigned short*>(a.w);
    bf16* p = reinterpret_cast<bf16*>(planes);
    constexpr int NB = BN / 8;
    for (int q = tid; q < kw * NB; q += THREADS) {
      const int nb = q % NB;
      const int kk = q / NB;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = n0 + 8 * nb + 2 * e;
        const long long r = (long long)kk * a.n;
        const uint32_t lo = (kk < a.t && c0 < a.n) ? wh[r + c0] : 0u;
        const uint32_t hi = (kk < a.t && c0 + 1 < a.n) ? wh[r + c0 + 1] : 0u;
        v[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(p + ((kk >> 3) * NB + nb) * 64 + (kk & 7) * 8) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    atb_tc::fence_proxy_async();  // the planes, to wgmma's reads
  }
  cluster.sync();  // every CTA's barriers initialised, its W staged

  const int warp = tid >> 5;
  const int lane = tid & 31;
  // the producer: this rank's jobs' 64-column chunks of X, by TMA multicast
  // to every CTA
  const uint16_t all = (uint16_t)((1u << cl) - 1);
  int c_chunk = rank % cpt;                                  // this rank's next job: its chunk
  long long c_row = (cid + (long long)(rank / cpt) * n_cl) * BM;  // and its tile's first row
  auto copy = [&](int s) {
    tma_multicast(smem_u32(ring + s * CHUNK), &xmap, c_chunk * 64, (int)c_row, smem_u32(full + s),
                  all);  // copy
    for (c_chunk += cl; c_chunk >= cpt;) {
      c_chunk -= cpt;
      c_row += n_cl * BM;
    }
  };
  if (tid >= CONSUMERS) {  // the producer warpgroup
    producer_regs();
    if (tid == CONSUMERS) Feed{full, empty, a.ring, cl, rank}.run(jobs, CHUNK, copy);
  } else {
    consumer_regs();
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's 16 rows of a tile
    const uint32_t plane = smem_u32(planes);
    constexpr uint32_t KSTRIDE = BN / 8 * 128;  // W: the next 8 k of a core-matrix column
    float acc[BN / 2], d[2][BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = d[0][i] = d[1][i] = 0.f;
    float rsum = 0.f, ssum = 0.f;  // this thread's half of row tid / 2 of the tile
    long long row0 = cid * BM;     // the tile's first row
    int it = 0;                    // tiles done
    int ci = 0;                    // the job's chunk of its tile
    // the row statistics of this tile: every rank's where they centre it,
    // else rank it % cl's, which stores them
    int stats_rank = 0;
    bool stats = a.inv_t != 0.f || stats_rank == rank;
    Pos pos{0, 0, a.ring % cl};
    for (long long j = 0; j < jobs; ++j) {
      const int s = pos.slot;
      const int col0 = ci * 64;
      mm_tc::mbar_wait(smem_u32(full + s), pos.phase);
      const unsigned char* st = ring + s * CHUNK;
      const uint32_t xa = smem_u32(st) + (warp >> 2) * 64 * 128;  // the warpgroup's 64 rows
      // the chunk's k16 steps as two chains of two from zero, each chain's
      // sum added into f32 rounded to nearest, in T order (MMA sums restart
      // every 32 columns of T).  All four steps of every chunk: past T the
      // copy's zero fill meets W's zero rows and adds exact zeros, and no
      // branch sits among the MMAs (ptxas injects waits around MMAs under
      // one).  A round of a tile's three chunks a wait read slower (14.27
      // against 12.90 ms at d = 3): its first MMAs waited on its last chunk.
#pragma unroll
      for (int h = 0; h < 2; ++h) atb_tc::hold(d[h]);
      atb_tc::wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wgmma_ss<0, 1>(d[q >> 1], sw128_k_desc(xa + 32 * q),
                       mm_tc::smem_desc(plane + (col0 / 16 + q) * 2 * KSTRIDE, KSTRIDE, 128),
                       (q & 1) == 0 ? 0 : 1);
      }
      atb_tc::wgmma_commit();
      if (stats) mm_tc::chunk_row_stats<bf16>(st, tid, false, rsum, ssum);
      atb_tc::wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h) atb_tc::hold(d[h]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += d[h][i];
      }
      release(empty, s, pos.next_issuer, tid);  // the MMAs and the row sums have read the slot
      pos.step(a.ring, cl);
      if (++ci == cpt) {  // the tile's last chunk: centre, round, stage, store
        ci = 0;
        unsigned char* stage = staged + (it & 1) * STAGE;
        rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
        ssum += __shfl_xor_sync(0xffffffffu, ssum, 1);
        if ((tid & 1) == 0) {
          const int rr = tid >> 1;
          mu[rr] = rsum * a.inv_t;
          if (rank == stats_rank && row0 + rr < a.m) {
            *reinterpret_cast<float2*>(a.stats + (row0 + rr) * 2) = make_float2(rsum, ssum);
          }
        }
        rsum = ssum = 0.f;
        if (tid == 0) bulk_wait_read<1>();  // the store of two tiles back has read this stage
        consumer_sync();
        // accumulator i: row g (+8 for i % 4 >= 2) of the warp's 16, column
        // 8 (i / 4) + 2 t + i % 2
#pragma unroll
        for (int i = 0; i < BN / 2; i += 2) {
          const int row = wrow + g + ((i & 3) >> 1) * 8;
          const int col = 8 * (i >> 2) + 2 * t4;
          const float m_r = mu[row];
          const float c0 = n0 + col < a.n ? __ldg(a.colw + n0 + col) : 0.f;
          const float c1 = n0 + col + 1 < a.n ? __ldg(a.colw + n0 + col + 1) : 0.f;
          *reinterpret_cast<uint32_t*>(stage + mm_tc::swz(row, 2 * col)) =
              atb_tc::pack_bf16(acc[i] - __fmul_rn(m_r, c0), acc[i + 1] - __fmul_rn(m_r, c1));
        }
        atb_tc::fence_proxy_async();  // the staged tile, to the store's reads
        consumer_sync();
        if (tid == 0) {
          tma_store(&ymap, n0, (int)row0, smem_u32(stage));  // store
          bulk_commit();
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        ++it;
        row0 += n_cl * BM;
        if (a.inv_t == 0.f && ++stats_rank == cl) stats_rank = 0;
        stats = a.inv_t != 0.f || stats_rank == rank;
      }
    }
    if (tid == 0) bulk_wait_all();
  }
  cluster.sync();  // no CTA leaves while another may still copy into it or arrive on it
}

// --------------------------------------------------------------- the Gram

struct GramArgs {
  double* part;        // n_share x N x N: each share's f64 blocks
  long long m;
  int n;
  int ring;            // slab slots
  int n_share;
  int plan[MAX_PLAN];  // block (mi << 8 | ni) of each CTA, cluster after cluster; +65536 a shadow
};

__global__ void __launch_bounds__(THREADS, 1)
    gram_cluster(const __grid_constant__ CUtensorMap ymap, const __grid_constant__ GramArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nbox = (a.n + 63) / 64;
  const int slot_bytes = nbox * GBOX;  // box k of a slab at k GBOX
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.ring * slot_bytes);
  uint64_t* empty = full + MAX_RING;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const int group = blockIdx.x / cl;
  const int share = blockIdx.y;
  // the cluster's boxes: which of its CTAs read each (an m side 2 mi,
  // 2 mi + 1, an n side ni), and the bytes this CTA receives
  uint32_t need[MAX_BOX];
#pragma unroll
  for (int k = 0; k < MAX_BOX; ++k) need[k] = 0;
  for (int r = 0; r < cl; ++r) {
    const int e = a.plan[group * cl + r];
    if (e < 0) continue;
    const int mi = (e >> 8) & 255, ni = e & 255;
#pragma unroll
    for (int k = 0; k < MAX_BOX; ++k) {
      if (k < nbox && (k == 2 * mi || k == 2 * mi + 1 || k == ni)) need[k] |= 1u << r;
    }
  }
  uint32_t my_bytes = 0;
#pragma unroll
  for (int k = 0; k < MAX_BOX; ++k) my_bytes += (need[k] >> rank) & 1u ? GBOX : 0u;
  const int mine = a.plan[group * cl + rank];
  const int mi = (mine >> 8) & 255, ni = mine & 255;
  const bool shadow = (mine >> 16) & 1;  // a padding CTA: computes another's block, writes nothing

  const long long n_tiles = (a.m + BM - 1) / BM;
  const long long my_tiles = share < n_tiles ? (n_tiles - 1 - share) / a.n_share + 1 : 0;
  const long long last_rows = a.m - (share + (my_tiles - 1) * a.n_share) * BM;
  const long long n_slabs = my_tiles == 0 ? 0 : (my_tiles - 1) * 2 + (last_rows > GR ? 2 : 1);
  auto rows = [&](long long s) { return (share + (s >> 1) * a.n_share) * BM + (s & 1) * GR; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < a.ring; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 2 * cl);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  // the producer: this rank's slabs' boxes that the cluster reads, each
  // once, by TMA multicast to the CTAs that read it
  long long c_slab = rank;  // this rank's next slab to copy
  auto copy = [&](int sl) {
    const int r0 = (int)rows(c_slab);
    for (int k = 0; k < nbox; ++k) {
      if (need[k] != 0) {
        tma_multicast(smem_u32(ring + sl * slot_bytes + k * GBOX), &ymap, 64 * k, r0, smem_u32(full + sl),
                      (uint16_t)need[k]);  // copy
      }
    }
    c_slab += cl;
  };
  if (tid >= CONSUMERS) {  // the producer warpgroup
    producer_regs();
    if (tid == CONSUMERS) Feed{full, empty, a.ring, cl, rank}.run(n_slabs, my_bytes, copy);
  } else {
    consumer_regs();
    const int w = warp >> 2;  // the warpgroup: G's rows 128 mi + 64 w on, from box 2 mi + w
    // an m side past N (N no multiple of 128) reads a box it holds and is
    // not written: no branch sits among the MMAs (ptxas serializes MMAs
    // under one, C7518)
    const bool active = 2 * mi + w < nbox;
    const int abox = min(2 * mi + w, nbox - 1);
    const int g = lane >> 2;
    const int t4 = lane & 3;
    float acc[32], d[2][32];
    double rsum[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[i] = d[0][i] = d[1][i] = 0.f;
      rsum[i] = 0.0;
    }
    // accumulators i % 2 == q into the f64 sums and from zero: slab q of
    // each tile folds them, so each sums exactly 128 rows in f32 between folds
    auto fold = [&](auto qc) {
      constexpr int Q = decltype(qc)::value;
#pragma unroll
      for (int i = Q; i < 32; i += 2) {
        rsum[i] += (double)acc[i];
        acc[i] = 0.f;
      }
    };
    Pos pos{0, 0, a.ring % cl};
    for (long long s = 0; s < n_slabs; ++s) {
      const int sl = pos.slot;
      mm_tc::mbar_wait(smem_u32(full + sl), pos.phase);
      const unsigned char* sa = ring + (long long)sl * slot_bytes;
      {  // two chains of two k16 steps (16 rows, 2,048 bytes, each) from zero
        const uint32_t pa = smem_u32(sa + abox * GBOX), pb = smem_u32(sa + ni * GBOX);
#pragma unroll
        for (int h = 0; h < 2; ++h) atb_tc::hold(d[h]);
        atb_tc::wgmma_fence();
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t off = (2 * h + q) * 2048;
            wgmma_ss<1, 1>(d[h], k3::sw128_mn_desc(pa + off, GBOX), k3::sw128_mn_desc(pb + off, GBOX),
                           q == 0 ? 0 : 1);
          }
        }
        atb_tc::wgmma_commit();
      }
      if (s & 1) {  // the staggered fold, beside the MMAs
        fold(std::integral_constant<int, 1>{});
      } else {
        fold(std::integral_constant<int, 0>{});
      }
      atb_tc::wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h) atb_tc::hold(d[h]);
      release(empty, sl, pos.next_issuer, tid);  // the warpgroup's MMAs have read the slot
      pos.step(a.ring, cl);
      {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the chains in row order
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] += d[h][i];
        }
      }
    }
    fold(std::integral_constant<int, 0>{});
    fold(std::integral_constant<int, 1>{});
    if (active && !shadow) {
      // accumulator i: G's row 128 mi + 64 w + 16 (warp % 4) + g (+8 for
      // i % 4 >= 2), column 64 ni + 8 (i / 4) + 2 t + i % 2
      double* dst = a.part + (size_t)share * a.n * a.n;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = 128 * mi + 64 * w + 16 * (warp & 3) + g + ((i & 3) >> 1) * 8;
        const int c = 64 * ni + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (r < a.n && c < a.n) dst[(size_t)r * a.n + c] = rsum[i];  // atb_reduce reads (min, max)
      }
    }
  }
  cluster.sync();
}

// ------------------------------------------------------------ host side

template <typename K>
cudaError_t allow(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

inline cudaLaunchConfig_t config(dim3 grid, int smem, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename K>
cudaError_t active_clusters(K kernel, int smem, int cluster, int* out) {
  const cudaError_t err = allow(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(dim3((unsigned)cluster), smem, cluster, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(out, (void*)kernel, &cfg);
}

inline bool cluster_ok(int cluster) { return cluster >= 1 && cluster <= MAX_CLUSTER; }

}  // namespace k2c

// Clusters of the sketch kernel (`cluster` CTAs, `ring` slots, X of T
// columns) resident on the card at once, into *out.  Returns a cudaError_t
// code.
extern "C" int k2c_sketch_clusters(int t, int cluster, int ring, int* out) {
  const int smem = k2c::sketch_smem(t, ring);
  if (!k2c::cluster_ok(cluster) || ring < 2 || ring > k2c::MAX_RING || smem > k2c::SMEM_CAP) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)k2c::active_clusters(k2c::sketch_cluster, smem, cluster, out);
}

// The same for the Gram kernel at N columns of Yc.
extern "C" int k2c_gram_clusters(int n, int cluster, int ring, int* out) {
  const int smem = k2c::gram_smem(n, ring);
  if (!k2c::cluster_ok(cluster) || ring < 2 || ring > k2c::MAX_RING || smem > k2c::SMEM_CAP) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)k2c::active_clusters(k2c::gram_cluster, smem, cluster, out);
}

// The sketch (stage 1): Yc (M x N bf16) and stats (M x 2 f32) from x (M x
// T bf16) and w (T x N bf16), colw (N f32, W's column sums) and inv_t, on
// `clusters` clusters of `cluster` CTAs (cluster 64 >= N) with `ring` slots,
// on `stream`.  Returns a cudaError_t code.
extern "C" int k2c_sketch_launch(const void* x, const void* w, const float* colw, void* yc,
                                 float* stats, long long m, int t, int n, float inv_t, int cluster,
                                 int ring, int clusters, void* stream) {
  using namespace k2c;
  const int smem = sketch_smem(t, ring);
  if (m < 1 || m > 0x7fffffffLL || t < 1 || t % 8 != 0 || n < 1 || n % 8 != 0 ||
      !cluster_ok(cluster) || cluster * BN < n || (cluster - 1) * BN >= n || ring < 2 ||
      ring > MAX_RING || smem > SMEM_CAP || clusters < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(yc) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap xmap{}, ymap{};
  cudaError_t err = k3::encode<bf16>(&xmap, x, m, t, 64, BM, true);
  if (err == cudaSuccess) err = k3::encode<bf16>(&ymap, yc, m, n, BN, BM, true);
  if (err == cudaSuccess) err = allow(sketch_cluster, smem);
  if (err != cudaSuccess) return (int)err;
  const SketchArgs args{static_cast<const bf16*>(w), colw, stats, inv_t, m, t, n, ring};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(dim3((unsigned)(clusters * cluster)), smem, cluster,
                                        static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, sketch_cluster, xmap, ymap, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// G (N x N f32) = Yc^T Yc of yc (M x N bf16) through the upper 128 x 64
// blocks of `plan` (n_plan entries mi << 8 | ni or -1, `cluster` a cluster),
// on n_share row shares (part: n_share N^2 doubles), `ring` slots, then
// atb_reduce, on `stream`.  Returns a cudaError_t code.
extern "C" int k2c_gram_launch(const void* yc, double* part, float* g, long long m, int n,
                               int cluster, int ring, int n_share, const int* plan, int n_plan,
                               void* stream) {
  using namespace k2c;
  const int smem = gram_smem(n, ring);
  if (m < 1 || m > 0x7fffffffLL || n < 1 || n % 8 != 0 || (n + 63) / 64 > MAX_BOX ||
      !cluster_ok(cluster) || ring < 2 || ring > MAX_RING || smem > SMEM_CAP || n_share < 1 ||
      n_share > 65535 || n_plan < 1 || n_plan > MAX_PLAN || n_plan % cluster != 0 ||
      part == nullptr || reinterpret_cast<uintptr_t>(yc) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  GramArgs args{part, m, n, ring, n_share, {}};
  for (int i = 0; i < MAX_PLAN; ++i) args.plan[i] = i < n_plan ? plan[i] : -1;
  CUtensorMap ymap{};
  cudaError_t err = k3::encode<bf16>(&ymap, yc, m, n, 64, GR, true);
  if (err == cudaSuccess) err = allow(gram_cluster, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaLaunchConfig_t cfg = config(dim3((unsigned)n_plan, (unsigned)n_share), smem, cluster, s, attr);
  err = cudaLaunchKernelEx(&cfg, gram_cluster, ymap, args);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n * n;
  atb_tc::atb_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(part, g, n_share, n, n, 1);
  return (int)cudaGetLastError();
}
