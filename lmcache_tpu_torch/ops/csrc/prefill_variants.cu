// The prefill ablation variants of row 1's attention body, for Hopper
// (sm_90a), built on that body (flash_sm90.cuh).
//
// Replaces the two TPU kernels of tools/bench_prefill_mfu.py:
// variant_kernel (pallas_call in build, modes full / mxu_only / no_mask and
// the two-blocks-a-step `pair`) and pipelined_kernel (pallas_call in
// build_pipelined: the QK product of one key block issued before the
// previous block's softmax and PV, from a score stash, with one drain step).
// Each variant computes the function of its TPU kernel, set by the logical
// query and key blocks bq and bk (multiples of 64, kernel arguments):
//
//   q [B, H, Tp, D] head-major (Tp a multiple of bq), K/V [B, H_kv, S, D],
//   all bf16; query block iq = t / bq; key block kb is live for it when
//   kb * bk <= q_offset[b] + (iq + 1) * bq - 1.
//   full      causal mask kpos <= min(qpos, kv_len - 1) inside the live
//             blocks, online softmax in fp32, P rounded to bf16 before PV,
//             0 for a row that sees no key: row 1's function;
//   no_mask   the same over every key of every live block, unmasked;
//   mxu_only  acc += bf16(scale * Q K^T) V over the live blocks, divided
//             by the number of live blocks (no max, no exponent);
//   pair      two key tiles a step, both QK products before either softmax
//             update (the wrapper refuses an odd count of key blocks, which
//             the TPU kernel's grid leaves the last of unvisited);
//   pipelined full's function, each tile's QK product issued before the
//             previous tile's softmax and PV.
//
// Design: the Hopper body of rows 1-7 (flash_sm90.cuh, whose device
// functions this file calls and whose kernel it leaves as it is). A block
// holds ROWS = 128 (token, head-in-group) rows of one (sequence, KV head),
// flattened token-major; a TMA producer warp keeps a ring of K/V tiles of
// BN keys (128; 64 in the two-tile schedules at D 128) full through
// mbarriers; two consumer warpgroups of 64 rows run S = Q K^T and
// O += P V as wgmma with S, P and O in registers, the online softmax in the
// log2 domain (softmax_tile). Shared memory holds Q and the ring only. One
// kernel template, variant_sm90_fwd<D, MODE, SCHEDULE>:
//   MODE      FULL: row 1's consumer loop without its options (no window,
//             softcap, sinks or int8), over the tiles row 1 visits (the
//             function does not depend on the blocks); NO_MASK: the
//             softmax with no select, but on the one tile that straddles
//             the consumer's live limit when bk is not a multiple of BN;
//             MXU_ONLY: O += bf16(scale * S) V with no max and no exponent
//             (the same select on the straddling tile), O divided by the
//             live logical blocks at the end.
//   SCHEDULE  STEP: row 1's, a tile at a time: QK, wait, softmax, PV, wait;
//             2 stages. PAIR: both QK products of two tiles, one commit and
//             one wait, then the two tiles' softmax updates and PVs in
//             order (the TPU kernel's sub(0), sub(1)); an odd tile count
//             leaves the last tile alone. PIPELINED: step g issues tile
//             g + 1's QK product and commits it without waiting, runs tile
//             g's softmax on its own score registers beside that product,
//             issues tile g's PV and then waits once for both (what the
//             next step needs: its scores and O); a drain step finishes the
//             last tile. Tile g's stage is released after its PV, so V lags
//             K by one tile and a consumer holds two stages: PAIR and
//             PIPELINED take 4 stages to keep loads in flight, and 64-key
//             tiles at D 128 (VariantGeometry).
// The logical blocks only decide the keys a consumer visits and masks. A
// consumer's 64 rows lie in one logical query block (the group size
// divides 64 and bq is a multiple of 64); the block's two consumers need
// not (G 1 and bq 64: 128 tokens), so each computes its own live-key limit,
// the producer loads up to the larger, and a consumer skips the tiles past
// its own but still waits for them and arrives on their empty barrier, as
// row 1's consumer does. V's rows at and past the block's limit are zeroed
// in the last tile before its PV (TMA loads whole boxes).
// No wgmma is in flight across a branch: the mask is chosen before a
// pipelined step issues its product.
//
// Bound on an H100: the tool's shape (S 8192, H 32, D 128) does
// 0.5 * S^2 * H * D * 4 = 550 GFLOP causally (more for the unmasked modes,
// which take every live block whole) on 168 MB, far above the card's ~295
// FLOP/byte ridge, so every variant is bound by its tensor-core operations,
// which wgmma is the one way to reach.

#include "flash_sm90.cuh"

namespace lmc {
namespace sm90 {

enum VariantMode { FULL = 0, NO_MASK = 1, MXU_ONLY = 2 };
enum VariantSchedule { STEP = 0, PAIR = 1, PIPELINED = 2 };

constexpr int LOGICAL = 64;  // bq and bk come in multiples of it

// A variant's tiles, ring and registers. Q's panels and layout are the
// body's (Geometry<D>). PAIR and PIPELINED keep two score tiles live
// beside O: at D 128 and 128 keys that is 64 + 64 + 64 fp32 a thread, past
// what the consumers' 232 registers hold (ptxas serializes their wgmma,
// and PIPELINED spills, also at 240 registers), so they take 64-key tiles
// there; at D 64 O is half as wide and 128 keys fit.
template <int D_, int SCHEDULE>
struct VariantGeometry {
  static constexpr int D = D_;
  using Gm = Geometry<D>;
  static_assert(Gm::PW == 64 && D <= 128, "D 64 or 128 only");
  static constexpr int BN = D == 64 || SCHEDULE == STEP ? 128 : 64;
  static constexpr int PW = Gm::PW, SWB = Gm::SWB, PANELS = Gm::PANELS;
  static constexpr int T_PANEL = BN * SWB;
  static constexpr int TILE = BN * D * 2;  // one K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int FIXED = Gm::ALIGN + CONSUMERS * Gm::Q_WG;
  static constexpr int MAX_STAGES = (SMEM_LIMIT - FIXED) / (STAGE + 16);
  // STEP: row 1's two stages; PAIR and PIPELINED hold two tiles and keep
  // one more load in flight
  static constexpr int STAGES =
      SCHEDULE == STEP ? 2 : (MAX_STAGES < 4 ? MAX_STAGES : 4);
  static_assert(STAGES >= (SCHEDULE == STEP ? 2 : 3), "too few stages");
  static constexpr int BYTES = FIXED + STAGES * (STAGE + 16);
  // setmaxnreg: row 1's split of the block's launch allocation (232 / 40)
  static constexpr int CONSUMER_REGS = Gm::CONSUMER_REGS;
  static constexpr int PRODUCER_REGS = Gm::PRODUCER_REGS;
};

// The keys [0, kend) a consumer visits, whose first row is fw, and the
// live key blocks of its logical query block (MXU_ONLY's divisor).
struct VariantRange {
  int kend, nlive;
};

template <int MODE>
__device__ __forceinline__ VariantRange variant_range(const FlashArgs& a,
                                                      const Block& blk,
                                                      int fw, int bq, int bk,
                                                      int nkb) {
  const int iq = fw / a.G / bq;
  const int qpos_max = blk.qoff + (iq + 1) * bq - 1;
  VariantRange v;
  v.nlive = max(0, min(qpos_max / bk + 1, nkb));
  if (MODE == FULL) {
    // row 1's causal limit, which lies inside the live blocks
    const int t_last = min((fw + 63) / a.G, a.T - 1);
    v.kend = max(0, min(blk.qoff + t_last + 1, blk.klen));
  } else {
    // every key of the live blocks, past the diagonal and kv_len too
    v.kend = min(v.nlive * bk, a.S);
  }
  return v;
}

// The ring of a block: the stages' addresses and barriers; a consumer
// takes each tile with acquire (in order, once) and gives it back with
// release.
template <class VG>
struct VariantRing {
  static constexpr int KV_OFF = CONSUMERS * Geometry<VG::D>::Q_WG;
  static constexpr int BAR_OFF = KV_OFF + VG::STAGES * VG::STAGE;
  uint32_t base;
  unsigned char* gbase;

  __device__ __forceinline__ uint32_t k_tile(int g) const {
    return base + KV_OFF + (g % VG::STAGES) * VG::STAGE;
  }
  __device__ __forceinline__ uint32_t v_tile(int g) const {
    return k_tile(g) + VG::TILE;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + BAR_OFF + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + BAR_OFF + 8 * (VG::STAGES + s);
  }

  // Wait for tile g; in the tile that reaches past the block's limit kend
  // the live consumers zero V's rows at and past it (0 * NaN is NaN) and
  // meet at named barrier 3 before either reads the tile.
  __device__ __forceinline__ void acquire(int g, const Block& blk, int w,
                                          int tid) const {
    constexpr int BN = VG::BN, SWB = VG::SWB;
    mbar_wait(full(g % VG::STAGES), (g / VG::STAGES) & 1);
    const int k0 = g * BN;
    if (k0 + BN > blk.kend) {
      constexpr int CHUNKS = VG::PANELS * SWB / 16;
      const int first = blk.kend - k0;
      unsigned char* vs = gbase + (v_tile(g) - base);
      for (int i = w * WG + tid; i < (BN - first) * CHUNKS;
           i += WG * blk.nlive) {
        const int row = first + i / CHUNKS;
        const int c = i % CHUNKS;
        *reinterpret_cast<uint4*>(vs + (c / (SWB / 16)) * VG::T_PANEL +
                                  row * SWB + (c % (SWB / 16)) * 16) =
            make_uint4(0, 0, 0, 0);
      }
      fence_async_smem();
      named_sync(3, WG * blk.nlive);
    }
  }

  __device__ __forceinline__ void release(int g, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(g % VG::STAGES));
  }
};

// S = Q K^T of the K tile at kaddr into sc: issued, not committed
template <class VG>
__device__ __forceinline__ void issue_qk(float (&sc)[VG::BN / 2],
                                         uint32_t qw, uint32_t kaddr) {
  using Gm = Geometry<VG::D>;
#pragma unroll
  for (int kk = 0; kk < VG::D / 16; ++kk) {
    const int p = kk * 16 / Gm::PW;
    const int within = (kk * 16 % Gm::PW) * 2;
    const uint64_t da = smem_desc(qw + p * Gm::Q_PANEL + within, 16,
                                  8 * Gm::SWB, Gm::LAYOUT);
    const uint64_t db = smem_desc(kaddr + p * VG::T_PANEL + within, 16,
                                  8 * Gm::SWB, Gm::LAYOUT);
    if constexpr (VG::BN == 128) {
      wgmma_ss_n128(sc, da, db, kk > 0);
    } else {
      wgmma_ss_n64(sc, da, db, kk > 0);
    }
  }
}

template <class VG>
using Acc = float[VG::PANELS][VG::PW / 2];  // O, D / 2 fp32 a thread
template <class VG>
using Frags = uint32_t[VG::BN / 16][4];  // P as wgmma's A fragments

// One tile's update of the thread's two rows from its scores in sc: the
// mode's P as wgmma's A fragments in pa (16 keys each: the accumulator
// layout of two 8-key groups is the A layout of one 16-key step) and, for
// the softmax modes, m, l and O rescaled. MASK: keys past qlim give 0.
template <class VG, int MODE, bool MASK>
__device__ __forceinline__ void variant_update(
    float (&sc)[VG::BN / 2], Frags<VG>& pa, Acc<VG>& o, float (&m)[2],
    float (&l)[2], const FlashArgs& a, int k0, int lane,
    const int (&qlim)[2], const int (&wlo)[2]) {
  constexpr int BN = VG::BN;
  if constexpr (MODE == MXU_ONLY) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int kpos = k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
      sc[i] = MASK && kpos > qlim[(i >> 1) & 1] ? 0.f : sc[i] * a.scale;
    }
  } else {
    float alpha[2];
    softmax_tile<BN, MASK, false>(sc, m, l, alpha, a, k0, lane, qlim, wlo);
#pragma unroll
    for (int p = 0; p < VG::PANELS; ++p) {
#pragma unroll
      for (int i = 0; i < VG::PW / 2; ++i) o[p][i] *= alpha[(i >> 1) & 1];
    }
  }
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }
  }
}

// O += P V of the V tile at vaddr, committed and waited for (with every
// group committed before it)
template <class VG>
__device__ __forceinline__ void pv_and_wait(Acc<VG>& o, const Frags<VG>& pa,
                                            uint32_t vaddr) {
  constexpr int SWB = VG::SWB;
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < VG::PANELS; ++p) reg_fence(o[p]);
#pragma unroll
  for (int kk = 0; kk < VG::BN / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < VG::PANELS; ++p) {
      const uint64_t db =
          smem_desc(vaddr + p * VG::T_PANEL + kk * 16 * SWB, 8 * SWB,
                    8 * SWB, Geometry<VG::D>::LAYOUT);
      wgmma_rs_n64(o[p], pa[kk], db);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int p = 0; p < VG::PANELS; ++p) reg_fence(o[p]);
}

// A tile's update and PV from its scores in sc (no product in flight)
template <class VG, int MODE, bool MASK>
__device__ __forceinline__ void update_and_pv(
    float (&sc)[VG::BN / 2], Acc<VG>& o, float (&m)[2], float (&l)[2],
    const FlashArgs& a, int k0, int lane, const int (&qlim)[2],
    const int (&wlo)[2], uint32_t vaddr) {
  Frags<VG> pa;
  variant_update<VG, MODE, MASK>(sc, pa, o, m, l, a, k0, lane, qlim, wlo);
  pv_and_wait<VG>(o, pa, vaddr);
}

// The same where `mask` (a tile that reaches past a row's limit) selects
// the masked update: a branch, so never with a product in flight
template <class VG, int MODE>
__device__ __forceinline__ void update_and_pv(
    bool mask, float (&sc)[VG::BN / 2], Acc<VG>& o, float (&m)[2],
    float (&l)[2], const FlashArgs& a, int k0, int lane,
    const int (&qlim)[2], const int (&wlo)[2], uint32_t vaddr) {
  if (mask) {
    update_and_pv<VG, MODE, true>(sc, o, m, l, a, k0, lane, qlim, wlo, vaddr);
  } else {
    update_and_pv<VG, MODE, false>(sc, o, m, l, a, k0, lane, qlim, wlo,
                                   vaddr);
  }
}

// PIPELINED's step with a next tile: tile g + 1's QK product into nxt
// beside tile g's update from cur, then tile g's PV and one wait for both
template <class VG, int MODE, bool MASK>
__device__ __forceinline__ void pipelined_step(
    float (&cur)[VG::BN / 2], float (&nxt)[VG::BN / 2], Acc<VG>& o,
    float (&m)[2], float (&l)[2], const FlashArgs& a, int k0, int lane,
    const int (&qlim)[2], const int (&wlo)[2], uint32_t qw, uint32_t k_next,
    uint32_t vaddr) {
  wgmma_fence();
  issue_qk<VG>(nxt, qw, k_next);
  wgmma_commit();
  update_and_pv<VG, MODE, MASK>(cur, o, m, l, a, k0, lane, qlim, wlo, vaddr);
  reg_fence(nxt);
}

template <int D, int MODE, int SCHEDULE>
__global__ void __launch_bounds__(THREADS, 1)
    variant_sm90_fwd(const FlashArgs a,
                     __grid_constant__ const CUtensorMap kmap,
                     __grid_constant__ const CUtensorMap vmap,
                     const TmaOrder ord, int bq, int bk, int nkb) {
  using VG = VariantGeometry<D, SCHEDULE>;
  using Gm = Geometry<D>;
  constexpr int BN = VG::BN, PW = VG::PW, PANELS = VG::PANELS;
  constexpr int STAGES = VG::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 1024-aligned base: generic pointer and shared address
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + Gm::ALIGN - 1) & ~uint32_t(Gm::ALIGN - 1);
  const VariantRing<VG> ring{base, smem_raw + (base - raw)};

  // no window (the entry refuses one): the tiles start at key 0
  Block blk = block_of<D, bf16>(a);
  if (MODE != FULL) {
    blk.kend = 0;
    for (int w = 0; w < blk.nlive; ++w) {
      blk.kend = max(blk.kend, variant_range<MODE>(a, blk, blk.f0 + 64 * w,
                                                   bq, bk, nkb).kend);
    }
  }
  blk.tiles = (blk.kend + BN - 1) / BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full(s), 1);  // the TMA's transaction
      mbar_init(ring.empty(s), 4 * blk.nlive);  // each consumer warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * WG) {
    // ---- producer: one thread keeps the ring full (flash_sm90_fwd's
    // dense loop)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        VG::PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * WG) {
      for (int g = 0; g < blk.tiles; ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(ring.empty(s), ((g / STAGES) - 1) & 1);
        mbar_expect_tx(ring.full(s), VG::STAGE);
        const int k0 = g * BN;
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load_panel(&kmap, ord.k, ring.k_tile(g) + p * VG::T_PANEL,
                         ring.full(s), p * PW, k0, blockIdx.y, blk.bkv);
          tma_load_panel(&vmap, ord.v, ring.v_tile(g) + p * VG::T_PANEL,
                         ring.full(s), p * PW, k0, blockIdx.y, blk.bkv);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      VG::CONSUMER_REGS));
  const int w = threadIdx.x / WG;
  if (w >= blk.nlive) return;  // no live row
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int fw = blk.f0 + 64 * w;
  const uint32_t qw = base + w * Gm::Q_WG;
  load_q<D>(ring.gbase + w * Gm::Q_WG, a, fw, blk.rows, tid);
  fence_async_smem();
  named_sync(1 + w, WG);

  const VariantRange vr = variant_range<MODE>(a, blk, fw, bq, bk, nkb);
  const int ntc = (vr.kend + BN - 1) / BN;  // the tiles this consumer takes
  // FULL: each row's causal limit (-1 for a row past the last); the
  // unmasked modes: the consumer's live limit, for the straddling tile
  int qlim[2];
  const int wlo[2] = {-0x40000000, -0x40000000};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = fw + warp * 16 + lane / 4 + 8 * j;
    qlim[j] = MODE != FULL ? vr.kend - 1
              : f < blk.rows ? min(blk.qoff + f / a.G, blk.klen - 1)
                             : -1;
  }
  // a tile needs the mask where it reaches past the first row's causal
  // limit (FULL, as row 1) or past the live limit
  const int open_end = MODE == FULL
                           ? min(blk.qoff + fw / a.G, blk.klen - 1) + 1
                           : vr.kend;

  Acc<VG> o;
#pragma unroll
  for (int p = 0; p < PANELS; ++p) {
#pragma unroll
    for (int i = 0; i < PW / 2; ++i) o[p][i] = 0.f;
  }
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float sc[BN / 2];

  // a tile the STEP way (row 1's): QK, wait, the update, PV, wait
  auto step = [&](int g) {
    const int k0 = g * BN;
    wgmma_fence();
    issue_qk<VG>(sc, qw, ring.k_tile(g));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);
    update_and_pv<VG, MODE>(k0 + BN > open_end, sc, o, m, l, a, k0, lane,
                            qlim, wlo, ring.v_tile(g));
  };

  if constexpr (SCHEDULE == STEP) {
    for (int g = 0; g < blk.tiles; ++g) {
      ring.acquire(g, blk, w, tid);
      if (g < ntc) step(g);
      ring.release(g, lane);
    }
  } else if constexpr (SCHEDULE == PAIR) {
    for (int g = 0; g < blk.tiles; g += 2) {
      const bool two = g + 1 < blk.tiles;
      ring.acquire(g, blk, w, tid);
      if (two) ring.acquire(g + 1, blk, w, tid);
      if (g + 1 < ntc) {
        // both products, one wait, then the two updates in order
        const int k0 = g * BN, k1 = k0 + BN;
        float sb[BN / 2];
        wgmma_fence();
        issue_qk<VG>(sc, qw, ring.k_tile(g));
        issue_qk<VG>(sb, qw, ring.k_tile(g + 1));
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);
        reg_fence(sb);
        update_and_pv<VG, MODE>(k0 + BN > open_end, sc, o, m, l, a, k0,
                                lane, qlim, wlo, ring.v_tile(g));
        update_and_pv<VG, MODE>(k1 + BN > open_end, sb, o, m, l, a, k1,
                                lane, qlim, wlo, ring.v_tile(g + 1));
      } else if (g < ntc) {
        step(g);  // the lone last tile
      }
      ring.release(g, lane);
      if (two) ring.release(g + 1, lane);
    }
  } else {
    float sb[BN / 2];
    // step g with tile g's scores in cur: issue g + 1's into nxt first
    // (the mask chosen before the product is issued), or drain the last
    auto pipe = [&](float (&cur)[BN / 2], float (&nxt)[BN / 2], int g) {
      const int k0 = g * BN;
      const bool mask = k0 + BN > open_end;
      if (g + 1 < ntc) {
        ring.acquire(g + 1, blk, w, tid);
        if (mask) {
          pipelined_step<VG, MODE, true>(cur, nxt, o, m, l, a, k0, lane, qlim,
                                         wlo, qw, ring.k_tile(g + 1),
                                         ring.v_tile(g));
        } else {
          pipelined_step<VG, MODE, false>(cur, nxt, o, m, l, a, k0, lane,
                                          qlim, wlo, qw, ring.k_tile(g + 1),
                                          ring.v_tile(g));
        }
      } else {
        update_and_pv<VG, MODE>(mask, cur, o, m, l, a, k0, lane, qlim, wlo,
                                ring.v_tile(g));
      }
      ring.release(g, lane);  // V of tile g read: its stage is free
    };
    if (ntc > 0) {
      ring.acquire(0, blk, w, tid);
      wgmma_fence();
      issue_qk<VG>(sc, qw, ring.k_tile(0));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
    }
    for (int g = 0; g < ntc; g += 2) {
      pipe(sc, sb, g);
      if (g + 1 < ntc) pipe(sb, sc, g + 1);
    }
    // the tiles past this consumer's limit, which the other one takes
    for (int g = ntc; g < blk.tiles; ++g) {
      ring.acquire(g, blk, w, tid);
      ring.release(g, lane);
    }
  }

  // normalize and write; MXU_ONLY: the sums over the live blocks. With no
  // live key m = -1e30 and l = 0, so the row gives 0.
  if (MODE == MXU_ONLY) l[0] = l[1] = static_cast<float>(vr.nlive);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = fw + warp * 16 + lane / 4 + 8 * j;
    if (f >= blk.rows) continue;
    const int head = blockIdx.y * a.G + f % a.G;
    const float inv = l[j] > 0.f ? 1.f / l[j] : 0.f;
    bf16* dst = static_cast<bf16*>(a.out) + blockIdx.z * a.ob +
                (f / a.G) * a.ot + static_cast<long long>(head) * a.oh;
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
#pragma unroll
      for (int c = 0; c < PW / 8; ++c) {
        const int i = 4 * c + 2 * j;
        *reinterpret_cast<__nv_bfloat162*>(dst + p * PW + c * 8 +
                                           2 * (lane & 3)) =
            __floats2bfloat162_rn(o[p][i] * inv, o[p][i + 1] * inv);
      }
    }
  }
}

// Encode the launch's K and V maps (dense pool, B rows, boxes of BN keys)
// and launch the variant on `stream`.
template <int D, int MODE, int SCHEDULE>
cudaError_t launch_variant(const FlashArgs& a, int B, int Hkv, int bq, int bk,
                           int nkb, cudaStream_t stream) {
  using VG = VariantGeometry<D, SCHEDULE>;
  constexpr int bytes = VG::BYTES;
  static_assert(bytes <= SMEM_LIMIT, "the ring does not fit shared memory");
  static std::atomic<int> raised[64];
  cudaError_t err =
      raise_smem_limit(variant_sm90_fwd<D, MODE, SCHEDULE>, bytes, raised);
  if (err != cudaSuccess) return err;
  CUtensorMap kmap, vmap;
  TmaOrder ord;
  const auto rows = static_cast<unsigned long long>(B);
  if (!encode_kv_map<D, bf16>(&kmap, ord.k, a.k, a.ks, a.kh, a.kb, a.S, Hkv,
                              rows, VG::BN) ||
      !encode_kv_map<D, bf16>(&vmap, ord.v, a.v, a.vs, a.vh, a.vb, a.S, Hkv,
                              rows, VG::BN)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((a.T * a.G + ROWS - 1) / ROWS, Hkv, B);
  variant_sm90_fwd<D, MODE, SCHEDULE>
      <<<grid, THREADS, bytes, stream>>>(a, kmap, vmap, ord, bq, bk, nkb);
  return cudaGetLastError();
}

template <int D>
cudaError_t variant_dispatch(const FlashArgs& a, int B, int Hkv, int mode,
                             int pair, int pipelined, int bq, int bk, int nkb,
                             cudaStream_t s) {
  if (pipelined) {
    return launch_variant<D, FULL, PIPELINED>(a, B, Hkv, bq, bk, nkb, s);
  }
  switch (mode * 2 + (pair ? 1 : 0)) {
    case FULL * 2:
      return launch_variant<D, FULL, STEP>(a, B, Hkv, bq, bk, nkb, s);
    case FULL * 2 + 1:
      return launch_variant<D, FULL, PAIR>(a, B, Hkv, bq, bk, nkb, s);
    case NO_MASK * 2:
      return launch_variant<D, NO_MASK, STEP>(a, B, Hkv, bq, bk, nkb, s);
    case NO_MASK * 2 + 1:
      return launch_variant<D, NO_MASK, PAIR>(a, B, Hkv, bq, bk, nkb, s);
    case MXU_ONLY * 2:
      return launch_variant<D, MXU_ONLY, STEP>(a, B, Hkv, bq, bk, nkb, s);
    case MXU_ONLY * 2 + 1:
      return launch_variant<D, MXU_ONLY, PAIR>(a, B, Hkv, bq, bk, nkb, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace lmc

// Plain C entry point, bound with ctypes: row 1's argument block (q and out
// strides of the head-major [B, H, Tp, D] tensors as [B, Tp, H, D] views;
// no window, softcap, sinks or kv_slot), the sizes it does not hold, the
// variant (mode 0 full, 1 no_mask, 2 mxu_only; pair; pipelined), the logical
// blocks bq and bk, the number of key blocks visited, the stream; returns a
// cudaError_t (0 on success).
extern "C" int lmc_prefill_variant(const lmc::FlashArgs* a, int B, int H,
                                   int Hkv, int D, int mode, int pair,
                                   int pipelined, int bq, int bk, int nkb,
                                   void* stream) {
  using namespace lmc::sm90;
  if (lmc::flash_bad_sizes(a, B, H, Hkv) || mode < 0 || mode > 2 ||
      bq <= 0 || bk <= 0 || bq % LOGICAL != 0 || bk % LOGICAL != 0 ||
      LOGICAL % a->G != 0 || a->T % bq != 0 || nkb < 0 ||
      (pipelined && (mode != FULL || pair)) || a->window > 0 ||
      a->softcap > 0.f || a->sinks != nullptr || a->kv_slot != nullptr) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return variant_dispatch<64>(*a, B, Hkv, mode, pair, pipelined, bq, bk,
                                  nkb, s);
    case 128:
      return variant_dispatch<128>(*a, B, Hkv, mode, pair, pipelined, bq, bk,
                                   nkb, s);
    default:
      return cudaErrorInvalidValue;
  }
}
