// The Hopper prefill body of the dense attention kernels
// (flash_attention.cu, flash_stream_attention.cu over bf16 K/V,
// quantized_flash_attention.cu over int8 K/V) and of the paged ones
// (paged_attention.cu, paged_stream_attention.cu over bf16 or int8 arenas):
// TMA, wgmma, and the scores, probabilities and output accumulator kept in
// registers.
//
// What the TPU kernels compute (lmcache_tpu/ops/attention.py::_flash_kernel
// and ::_flash_dma_kernel): for each (sequence, KV head, block of query
// rows), an online softmax over the causally live key blocks, S = Q K^T
// scaled (softcapped, masked by the causal limit, kv_len and the window),
// P = exp(S - m) rounded to bf16, O += P V, and at the end O / l with the
// attention sinks joined to l. The contract is that of flash_args.cuh.
// Over int8 K/V (lmcache_tpu/ops/quantized_attention.py::_qflash_kernel)
// each key carries one fp32 scale a side: the K scale multiplies the score
// column (times the score scale) before softcap and masks, the row sum is
// taken from P, and the V scale then multiplies P's column before P is
// rounded to bf16.
//
// Design, per block of ROWS = 128 query rows, (token, head-in-group) pairs
// of one (sequence, KV head) flattened token-major (so every group size
// works, 5 included), three warpgroups:
// - warpgroup 2, the producer, gives its registers to the others
//   (setmaxnreg) and one of its threads keeps TMA loads of K and V tiles
//   of BN keys in flight through a ring of STAGES stages, with mbarrier
//   full and empty barriers. The tiles run from the one that holds the
//   window's first key to the causal limit, so dead tiles are neither read
//   nor computed.
// - warpgroups 0 and 1, the consumers, own 64 rows each. A consumer loads
//   its Q rows once with 16-byte loads (a block of 64 rows is 64 / G
//   tokens, not a TMA box when G is 5), then per tile runs S = Q K^T as
//   wgmma (A = Q and B = the K tile, both K-major in shared memory, fp32
//   accumulators in registers: a row lies in a quad of threads), the
//   online softmax on S in registers (masks, softcap and window are
//   selects; the row max and sum are reduced over the quad with shfl_xor 1
//   and 2), converts P to bf16 in registers and feeds it as wgmma's
//   register A operand into O += P V (B = the V tile, MN-major: the
//   transpose bit). O stays in registers, D / 2 fp32 a thread, and is
//   written once at the end, with the sink correction there.
// - Shared memory holds Q and the ring only. K, V and Q are stored in
//   panels of PW columns (64, or 32 at D = 96, whose 192-byte rows take a
//   64-byte swizzle), each row of a panel one swizzle atom wide: the TMA
//   maps' swizzle (128 or 64 bytes) and the wgmma descriptors' layout
//   agree by construction, and Q is written by hand in the same pattern.
// - TMA reads whole boxes: K/V rows at and past kend inside the pool are
//   loaded. Masked scores are selects, so K's tail is harmless, but
//   0 * NaN is NaN, so the consumers zero V's tail rows of the last tile in
//   shared memory before its PV product.
// - int8 K/V (KV = i8): wgmma has no bf16 x int8 form and Q stays bf16, so
//   the producer's thread brings the int8 tiles by TMA (unswizzled boxes of
//   D bytes by BN keys) into a staging ring of STAGES8 stages, and the
//   producer warpgroup's three other warps, idle in the bf16 body, convert
//   each tile exactly into the bf16 panels, in the swizzled layout the
//   consumers' descriptors read, writing zeros at and past kend. They load
//   the tile's BN K and V scales too (0 at and past kend) with plain loads:
//   a row of scales need not meet TMA's 16-byte alignment. A staging stage
//   is free once converted; a bf16 stage once both consumers are done.
//   Shared memory holds Q, 2 bf16 stages with their scales and a staging
//   ring of 4 stages, deep enough that the loads' latency hides behind
//   the conversion (with 2, on an H100, the converting warps alone, no
//   product run, took longer than row 1's whole prefill): tiles of 128 keys at D 64
//   and 96 (167,040 and 224,352 bytes), 64 at D 128 (165,984) and 32 at
//   D 256 (198,240).
// - Tile source (PAGED): the dense pool [B, H_kv, S, D], a box of BN keys a
//   panel at (column, key, KV head, sequence); or a paged arena [P, H_kv,
//   page, D] (paged_attention.cu, paged_stream_attention.cu), read in place
//   through page_table [B, NP]: the arena is a 4-d map whose key dimension
//   is the row in page and whose pool row is the page id, and a tile of BN
//   keys loads as pieces of `box` rows (gcd(BN, page), so a box never
//   crosses a page) at (column, row in page, KV head, page id). The
//   producer warp's 32 lanes hold 32 consecutive page ids of the block's
//   table, one load a lane. Pieces at and past kend, and pieces wholly
//   before the block's oldest visible key, are not loaded: dead slots are
//   never read, and their shared memory keeps an older tile's rows, which
//   the consumers zero in V as they zero V's tail (K's are masked). A
//   page id outside the pool (< 0 or >= P) lies outside the map and reads
//   as zeros, TMA's fill. Tile points are the dense body's.
// - int8 arena (PAGED, KV = i8): the producer warp lands the pieces, whole
//   rows of D bytes (int8 boxes of at least 16 rows: TMA's alignment), in
//   the staging ring; the converting warps read each key's two scales
//   through the page table (0 for a page id outside the pool, and 0 for the
//   keys before the block's oldest visible key, where a dead page may hold
//   NaN), and write the rows of unloaded pieces and those at and past kend
//   as symbol 0 with scale 0, so the bf16 stage is whole and the consumers
//   zero nothing. The scales are selected, not multiplied, so NaN in a dead
//   page's scales stays out.
// - No float atomics and a fixed order of every sum: two launches on the
//   same inputs give the same bits.
// Tiles: BN = 128 keys at D 64, 96 and 128, 64 at D 256 (O alone takes 128
// registers a thread there). The overlap of the softmax with the next
// product and ping-pong between the consumers are left to a later
// revision.
//
// Bound on an H100: a prefill of T tokens over S keys does
// 4 * H * D * (live key pairs) operations on about 2 * (T*H*D + 2*S*H_kv*D)
// bytes (int8: half the K/V bytes, plus 8 a key of scales), far above the
// card's ~295 FLOP/byte ridge: bound by the tensor-core operations, which
// wgmma is the one way to reach; the int8 conversion runs beside them on
// warps that would otherwise idle.

#pragma once

#include <utility>

#include "flash_args.cuh"
#include "sm90_ptx.cuh"

namespace lmc {
namespace sm90 {

constexpr int WG = 128;         // threads of a warpgroup
constexpr int CONSUMERS = 2;    // consumer warpgroups of 64 rows each
constexpr int ROWS = 64 * CONSUMERS;
constexpr int THREADS = WG * (CONSUMERS + 1);
// int8 K/V: the producer warpgroup's threads past its TMA warp convert,
// with a few more registers than a bf16 producer needs
constexpr int CONVERTERS = WG - 32;
constexpr int CONVERT_VECTORS = 4;  // 16-byte vectors in flight a thread

template <int D, typename KV = bf16>
struct Geometry {
  static constexpr bool QUANT = sizeof(KV) == 1;
  // keys a tile: bf16 128 (64 at D 256, where O takes 128 registers a
  // thread); int8 128 at D 64 and 96, else tiles of 16 KB, so that 4
  // staging stages fit beside 2 bf16 stages at every D
  static constexpr int BN = QUANT ? (D <= 96 ? 128 : 8192 / D)
                                  : (D == 256 ? 64 : 128);
  static constexpr int PW = D % 64 == 0 ? 64 : 32;  // columns a panel
  static constexpr int SWB = 2 * PW;                // bytes a panel row
  static constexpr int PANELS = D / PW;
  static constexpr int LAYOUT = PW == 64 ? 1 : 2;   // wgmma: 128B / 64B
  static constexpr int SWZ_MASK = SWB / 16 - 1;
  static constexpr int Q_PANEL = 64 * SWB;          // a consumer's panel
  static constexpr int Q_WG = 64 * D * 2;           // a consumer's Q
  static constexpr int T_PANEL = BN * SWB;
  static constexpr int TILE = BN * D * 2;           // one K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int ALIGN = 1024;  // the swizzle pattern's period
  // int8 only: a staging stage (K and V tiles as TMA lands them) and the K
  // and V scales of a bf16 stage
  static constexpr int TILE8 = QUANT ? BN * D : 0;
  static constexpr int STAGE8 = 2 * TILE8;
  static constexpr int SCALES = QUANT ? 2 * BN * 4 : 0;
  static constexpr int fixed(int stages) {
    return ALIGN + CONSUMERS * Q_WG + stages * (STAGE + SCALES + 16);
  }
  static constexpr int STAGES8 =
      !QUANT ? 0
             : (SMEM_LIMIT - fixed(2)) / (STAGE8 + 16) < 4
                   ? (SMEM_LIMIT - fixed(2)) / (STAGE8 + 16)
                   : 4;
  // registers a thread (setmaxnreg): 128 * producer + 256 * consumer
  // may not pass the block's launch allocation, 384 * 168 = 64,512 (a
  // consumer's setmaxnreg.inc waits for registers until they are free)
  static constexpr int PRODUCER_REGS = QUANT ? 56 : 40;
  static constexpr int CONSUMER_REGS = QUANT ? 224 : 232;
  static constexpr int bytes(int stages) {
    return fixed(stages) + STAGES8 * (STAGE8 + 16);
  }
  static constexpr int max_stages() {
    return (SMEM_LIMIT - ALIGN - CONSUMERS * Q_WG) / (STAGE + 16);
  }
};

// The coordinate (1..3) of a 4-d K or V tensor map that carries the key,
// the KV head and the pool row: the host orders the three dimensions by
// stride, whatever the layout.
struct TmaOrder {
  int k[3];
  int v[3];
};

// ------------------------------------------------------------ body ---

// The online-softmax update of a thread's two rows over one tile of scores
// in registers, in the log2 domain (scores times log2 e, so that each
// exponent is one ex2): element i is row (i >> 1) & 1 of the thread's pair,
// key k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1); a row's max and sum are
// reduced over its quad of threads. MASK: the causal limit, kv_len and the
// window are selects on the scores, and a key masked so far gives 0.
// QUANT: ksc holds the tile's K scales (0 past kend), each multiplying its
// score column with the score scale before softcap and mask.
// Leaves P (fp32) in sc, the rescale factors of O in alpha.
template <int BN, bool MASK, bool SOFTCAP, bool QUANT = false>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const FlashArgs& a, int k0,
                                             int lane, const int (&qlim)[2],
                                             const int (&wlo)[2],
                                             const float* ksc = nullptr) {
  const float scale2 = a.scale * LOG2E;
  const float cap2 = a.softcap * LOG2E;
  if constexpr (QUANT) {
    // a thread's keys come in pairs: (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
    // the key's scale times the score scale (and log2 e without softcap)
    const float kscale = SOFTCAP ? a.scale : scale2;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const float2 ks =
          *reinterpret_cast<const float2*>(ksc + c * 8 + 2 * (lane & 3));
      const float k0s = ks.x * kscale, k1s = ks.y * kscale;
      sc[4 * c] *= k0s;
      sc[4 * c + 1] *= k1s;
      sc[4 * c + 2] *= k0s;
      sc[4 * c + 3] *= k1s;
    }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int j = (i >> 1) & 1;
    float x;
    if constexpr (QUANT) {
      x = SOFTCAP ? cap2 * tanhf(sc[i] / a.softcap) : sc[i];
    } else {
      x = SOFTCAP ? cap2 * tanhf(sc[i] * a.scale / a.softcap)
                  : sc[i] * scale2;
    }
    if (MASK) {
      const int kpos = k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
      x = kpos <= qlim[j] && kpos > wlo[j] ? x : NEG_INF;
    }
    sc[i] = x;
    mx[j] = fmaxf(mx[j], x);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    const float m_new = fmaxf(m[j], mx[j]);
    alpha[j] = ex2(m[j] - m_new);
    m[j] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int j = (i >> 1) & 1;
    const float p = !MASK || sc[i] > 0.5f * NEG_INF ? ex2(sc[i] - m[j])
                                                    : 0.f;
    sc[i] = p;
    sum[j] += p;  // the row sum before the bf16 rounding
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 1);
    sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 2);
    l[j] = alpha[j] * l[j] + sum[j];
  }
}

template <int D>
__device__ __forceinline__ int swizzle(int off) {
  return off ^ (((off >> 7) & Geometry<D>::SWZ_MASK) << 4);
}

// What a block works on: its rows, its sequence's limits, the keys
// [kfirst, kend) that some row of it can see (kbeg: kfirst rounded down to
// a tile) and the consumers that own a live row.
struct Block {
  int f0, rows, qoff, klen, kfirst, kbeg, kend, tiles, nlive, bkv;
};

template <int D, typename KV>
__device__ __forceinline__ Block block_of(const FlashArgs& a) {
  constexpr int BN = Geometry<D, KV>::BN;
  Block r;
  const int b = blockIdx.z;
  // the last rows have the most keys: schedule them first
  r.f0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  r.rows = a.T * a.G;
  r.qoff = a.q_offset[b];
  r.klen = min(a.kv_len[b], a.S);
  r.bkv = a.kv_slot != nullptr ? a.kv_slot[0] : b;
  const int t_last = min((r.f0 + ROWS - 1) / a.G, a.T - 1);
  r.kend = max(0, min(r.qoff + t_last + 1, r.klen));
  r.kfirst = window_start(a, r.qoff + r.f0 / a.G);
  r.kbeg = r.kfirst / BN * BN;
  r.tiles = r.kend > r.kbeg ? (r.kend - r.kbeg + BN - 1) / BN : 0;
  r.nlive = r.rows - r.f0 > 64 ? 2 : 1;
  return r;
}

// A consumer's 64 Q rows into its panels (zero past the last row).
template <int D>
__device__ __forceinline__ void load_q(unsigned char* qs, const FlashArgs& a,
                                       int fw, int rows, int tid) {
  using Gm = Geometry<D>;
  const bf16* qbase = static_cast<const bf16*>(a.q) + blockIdx.z * a.qb +
                      static_cast<long long>(blockIdx.y) * a.G * a.qh;
  for (int i = tid; i < 64 * D / 8; i += WG) {
    const int rr = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int f = fw + rr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (f < rows) {
      val = *reinterpret_cast<const uint4*>(qbase + (f / a.G) * a.qt +
                                            (f % a.G) * a.qh + c);
    }
    *reinterpret_cast<uint4*>(
        qs + (c / Gm::PW) * Gm::Q_PANEL +
        swizzle<D>(rr * Gm::SWB + (c % Gm::PW) * 2)) = val;
  }
}

// K or V tile panel: pick the map coordinate that carries each index
__device__ __forceinline__ void tma_load_panel(const CUtensorMap* map,
                                               const int (&pos)[3],
                                               uint32_t dst, uint32_t bar,
                                               int col, int key, int head,
                                               int row) {
  auto at = [&](int i) {
    return pos[0] == i ? key : (pos[1] == i ? head : row);
  };
  tma_load_4d(dst, map, bar, col, at(1), at(2), at(3));
}

// Paged arena: the producer warp keeps the ring full, a TMA box a piece of
// `box` rows, panel and side at (column, row in page, KV head, page id);
// only the pieces that hold a key of [kfirst, kend) are loaded. The lanes
// hold the page ids of 32 consecutive slots of the block's table from slot
// `win` on, and lane 0 issues the loads. int8: the ring is the staging
// ring, a piece one box of whole D-byte rows a side.
template <int D, int STAGES, typename KV = bf16>
__device__ __forceinline__ void load_paged_tiles(
    const FlashArgs& a, const Block& blk, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const TmaOrder& ord, uint32_t ring,
    uint32_t bar_full, uint32_t bar_empty, int lane) {
  using Gm = Geometry<D, KV>;
  constexpr int BN = Gm::BN;
  // bytes a stage, a side and a row of a panel; panels a side
  constexpr int STAGE = Gm::QUANT ? Gm::STAGE8 : Gm::STAGE;
  constexpr int SIDE = Gm::QUANT ? Gm::TILE8 : Gm::TILE;
  constexpr int ROW = Gm::QUANT ? D : Gm::SWB;
  constexpr int PANELS = Gm::QUANT ? 1 : Gm::PANELS;
  const int d = a.box;
  const int* table =
      a.page_table + static_cast<long long>(blockIdx.z) * a.NP;
  const int slot_end = (blk.kend + a.page - 1) / a.page;
  int win = -0x40000000, ids = 0;
  for (int g = 0; g < blk.tiles; ++g) {
    const int s = g % STAGES;
    if (g >= STAGES) mbar_wait(bar_empty + 8 * s, ((g / STAGES) - 1) & 1);
    const int k0 = blk.kbeg + g * BN;
    // pieces [j0, j1) of the tile: none wholly before kfirst or past kend
    const int j0 = max(0, blk.kfirst - k0) / d;
    const int j1 = max(j0, (min(BN, blk.kend - k0) + d - 1) / d);
    if (lane == 0) {
      mbar_expect_tx(bar_full + 8 * s, 2 * PANELS * (j1 - j0) * d * ROW);
    }
    for (int j = j0; j < j1; ++j) {
      const int kj = k0 + j * d;
      const int slot = kj / a.page;
      if (slot < win || slot >= win + 32) {  // the same on every lane
        win = slot;
        ids = slot + lane < slot_end ? table[slot + lane] : 0;
      }
      const int pid = __shfl_sync(0xffffffffu, ids, slot - win);
      if (lane == 0) {
        const uint32_t dst = ring + s * STAGE + j * d * ROW;
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load_panel(kmap, ord.k, dst + p * Gm::T_PANEL, bar_full + 8 * s,
                         p * Gm::PW, kj % a.page, blockIdx.y, pid);
          tma_load_panel(vmap, ord.v, dst + SIDE + p * Gm::T_PANEL,
                         bar_full + 8 * s, p * Gm::PW, kj % a.page,
                         blockIdx.y, pid);
        }
      }
    }
  }
}

// int8 K/V: the converting warps of the producer warpgroup (ct < 96) turn
// each staged int8 tile into the bf16 panels and scales of its ring stage,
// zero at and past kend; the stage is signalled full once all three warps
// are done, and the staging stage free. The next tile's scales are loaded
// into registers while this tile is converted, so that their device-memory
// latency does not hold up every tile. PAGED: a key's scales are entry
// k % page of row page_table[b, k / page] of the scale pools, 0 before
// kfirst and for a page id outside the pool; the rows of the pieces before
// kfirst that were not loaded are converted as zeros.
template <int D, int STAGES, bool PAGED = false>
__device__ __forceinline__ void convert_tiles(
    const FlashArgs& a, const Block& blk, unsigned char* gbase, int kv_off,
    int k8_off, int sc_off, uint32_t bar_full, uint32_t bar_empty,
    uint32_t bar_full8, uint32_t bar_empty8, int ct) {
  using Gm = Geometry<D, i8>;
  constexpr int BN = Gm::BN, PW = Gm::PW, S8 = Gm::STAGES8;
  constexpr int CHUNKS = BN * (D / 16);  // 16-byte vectors of a tile
  constexpr int NSC = (BN + CONVERTERS - 1) / CONVERTERS;  // scales a thread
  const float* ksb = a.k_scale + static_cast<long long>(blk.bkv) * a.ksb;
  const float* vsb = a.v_scale + static_cast<long long>(blk.bkv) * a.vsb;
  const int* table =
      PAGED ? a.page_table + static_cast<long long>(blockIdx.z) * a.NP
            : nullptr;
  float next_k[NSC], next_v[NSC];  // tile g's scales, 0 at and past kend
  auto fetch = [&](int g) {
#pragma unroll
    for (int j = 0; j < NSC; ++j) {
      const int c = ct + j * CONVERTERS;
      if constexpr (PAGED) {
        const int k = blk.kbeg + g * BN + c;
        const int pid =
            c < BN && k >= blk.kfirst && k < blk.kend ? table[k / a.page] : -1;
        const bool in = pid >= 0 && pid < a.P;
        const long long row = in ? static_cast<long long>(pid) : 0;
        const float ks = a.k_scale[row * a.ksb + (k % a.page) * a.kss];
        const float vs = a.v_scale[row * a.vsb + (k % a.page) * a.vss];
        next_k[j] = in ? ks : 0.f;
        next_v[j] = in ? vs : 0.f;
      } else {
        const long long k = blk.kbeg + g * BN + c;
        const bool in = c < BN && k < blk.kend;
        next_k[j] = in ? ksb[k * a.kss] : 0.f;
        next_v[j] = in ? vsb[k * a.vss] : 0.f;
      }
    }
  };
  if (blk.tiles > 0) fetch(0);
  for (int g = 0; g < blk.tiles; ++g) {
    const int s = g % STAGES, s8 = g % S8;
    const int k0 = blk.kbeg + g * BN;
    const int live = blk.kend - k0;  // keys of the tile below kend
    float cur_k[NSC], cur_v[NSC];
#pragma unroll
    for (int j = 0; j < NSC; ++j) {
      cur_k[j] = next_k[j];
      cur_v[j] = next_v[j];
    }
    if (g + 1 < blk.tiles) fetch(g + 1);
    if (g >= STAGES) mbar_wait(bar_empty + 8 * s, ((g / STAGES) - 1) & 1);
    mbar_wait(bar_full8 + 8 * s8, (g / S8) & 1);
    const unsigned char* src = gbase + k8_off + s8 * Gm::STAGE8;
    // PAGED: the rows of the pieces wholly before kfirst, not loaded
    const int lead = PAGED ? max(0, blk.kfirst - k0) / a.box * a.box : 0;
    // CONVERT_VECTORS loads in flight, then their conversions and stores
    // (rows at and past kend, and before lead, read as symbol 0, which
    // converts to 0)
    for (int i0 = ct; i0 < 2 * CHUNKS; i0 += CONVERT_VECTORS * CONVERTERS) {
      uint4 raw[CONVERT_VECTORS];
#pragma unroll
      for (int u = 0; u < CONVERT_VECTORS; ++u) {
        const int i = i0 + u * CONVERTERS;
        const int row = (i % CHUNKS) / (D / 16);
        raw[u] = make_uint4(0, 0, 0, 0);
        if (i < 2 * CHUNKS && row < live && (!PAGED || row >= lead)) {
          raw[u] = *reinterpret_cast<const uint4*>(
              src + (i / CHUNKS) * Gm::TILE8 + row * D + (i % (D / 16)) * 16);
        }
      }
#pragma unroll
      for (int u = 0; u < CONVERT_VECTORS; ++u) {
        const int i = i0 + u * CONVERTERS;
        if (i >= 2 * CHUNKS) break;
        const int row = (i % CHUNKS) / (D / 16);
        const int c = (i % (D / 16)) * 16;
        uint4 lo, hi;
        i8x16_to_bf16(raw[u], lo, hi);
        unsigned char* dst = gbase + kv_off + s * Gm::STAGE +
                             (i / CHUNKS) * Gm::TILE + (c / PW) * Gm::T_PANEL;
        const int off = row * Gm::SWB + (c % PW) * 2;
        *reinterpret_cast<uint4*>(dst + swizzle<D>(off)) = lo;
        *reinterpret_cast<uint4*>(dst + swizzle<D>(off + 16)) = hi;
      }
    }
    float* sc = reinterpret_cast<float*>(gbase + sc_off + s * Gm::SCALES);
#pragma unroll
    for (int j = 0; j < NSC; ++j) {
      const int c = ct + j * CONVERTERS;
      if (c < BN) {
        sc[c] = cur_k[j];
        sc[BN + c] = cur_v[j];
      }
    }
    fence_async_smem();  // the panels are read by wgmma (async proxy)
    __syncwarp();
    if (ct % 32 == 0) {
      mbar_arrive(bar_empty8 + 8 * s8);
      mbar_arrive(bar_full + 8 * s);
    }
  }
}

// PAGED: K/V (int8: and their scales) from a paged arena through the page
// table (else the dense pool).
template <int D, int STAGES, bool SOFTCAP, typename KV = bf16,
          bool PAGED = false>
__global__ void __launch_bounds__(THREADS, 1)
    flash_sm90_fwd(const FlashArgs a, __grid_constant__ const CUtensorMap kmap,
                   __grid_constant__ const CUtensorMap vmap,
                   const TmaOrder ord) {
  using Gm = Geometry<D, KV>;
  constexpr bool QUANT = Gm::QUANT;
  // the paged converters also walk the page table: with 56 registers
  // ptxas spills 72-164 bytes of them at D 64-128, with 64 at most 16;
  // 64 * 128 + 216 * 256 stays within the block's launch allocation
  constexpr int PRODUCER_REGS = QUANT && PAGED ? 64 : Gm::PRODUCER_REGS;
  constexpr int CONSUMER_REGS = QUANT && PAGED ? 216 : Gm::CONSUMER_REGS;
  constexpr int BN = Gm::BN, PW = Gm::PW, PANELS = Gm::PANELS;
  constexpr int S8 = Gm::STAGES8;
  extern __shared__ unsigned char smem_raw[];
  // 1024-aligned base: generic pointer and shared address
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + Gm::ALIGN - 1) & ~uint32_t(Gm::ALIGN - 1);
  unsigned char* gbase = smem_raw + (base - raw);
  // Q, the bf16 ring, the int8 staging ring, the scales, the barriers
  constexpr int KV_OFF = CONSUMERS * Gm::Q_WG;
  constexpr int K8_OFF = KV_OFF + STAGES * Gm::STAGE;
  constexpr int SC_OFF = K8_OFF + S8 * Gm::STAGE8;
  constexpr int BAR_OFF = SC_OFF + STAGES * Gm::SCALES;
  auto k_stage = [&](int s) { return KV_OFF + s * Gm::STAGE; };
  auto v_stage = [&](int s) { return KV_OFF + s * Gm::STAGE + Gm::TILE; };
  auto full = [&](int s) { return base + BAR_OFF + 8 * s; };
  auto empty = [&](int s) { return base + BAR_OFF + 8 * (STAGES + s); };
  auto full8 = [&](int s) { return base + BAR_OFF + 8 * (2 * STAGES + s); };
  auto empty8 = [&](int s) {
    return base + BAR_OFF + 8 * (2 * STAGES + S8 + s);
  };

  const Block blk = block_of<D, KV>(a);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // full: the TMA's transaction (bf16) or the three converting warps
      mbar_init(full(s), QUANT ? CONVERTERS / 32 : 1);
      mbar_init(empty(s), 4 * blk.nlive);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < S8; ++s) {
      mbar_init(full8(s), 1);
      mbar_init(empty8(s), CONVERTERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * WG) {
    // ---- producer: one thread keeps the ring full (int8: the staging
    // ring, which the other three warps convert into the ring)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    const int pt = threadIdx.x - CONSUMERS * WG;
    if constexpr (QUANT && PAGED) {
      if (pt < 32) {
        load_paged_tiles<D, S8, i8>(a, blk, &kmap, &vmap, ord, base + K8_OFF,
                                    full8(0), empty8(0), pt);
      } else {
        convert_tiles<D, STAGES, true>(a, blk, gbase, KV_OFF, K8_OFF, SC_OFF,
                                       full(0), empty(0), full8(0), empty8(0),
                                       pt - 32);
      }
    } else if constexpr (QUANT) {
      if (pt == 0) {
        for (int g = 0; g < blk.tiles; ++g) {
          const int s8 = g % S8;
          if (g >= S8) mbar_wait(empty8(s8), ((g / S8) - 1) & 1);
          mbar_expect_tx(full8(s8), Gm::STAGE8);
          const int k0 = blk.kbeg + g * BN;
          tma_load_panel(&kmap, ord.k, base + K8_OFF + s8 * Gm::STAGE8,
                         full8(s8), 0, k0, blockIdx.y, blk.bkv);
          tma_load_panel(&vmap, ord.v,
                         base + K8_OFF + s8 * Gm::STAGE8 + Gm::TILE8,
                         full8(s8), 0, k0, blockIdx.y, blk.bkv);
        }
      } else if (pt >= 32) {
        convert_tiles<D, STAGES>(a, blk, gbase, KV_OFF, K8_OFF, SC_OFF,
                                 full(0), empty(0), full8(0), empty8(0),
                                 pt - 32);
      }
    } else if constexpr (PAGED) {
      if (pt < 32) {
        load_paged_tiles<D, STAGES>(a, blk, &kmap, &vmap, ord, base + KV_OFF,
                                    full(0), empty(0), pt);
      }
    } else if (pt == 0) {
      for (int g = 0; g < blk.tiles; ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(empty(s), ((g / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), Gm::STAGE);
        const int k0 = blk.kbeg + g * BN;
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load_panel(&kmap, ord.k, base + k_stage(s) + p * Gm::T_PANEL,
                         full(s), p * PW, k0, blockIdx.y, blk.bkv);
          tma_load_panel(&vmap, ord.v, base + v_stage(s) + p * Gm::T_PANEL,
                         full(s), p * PW, k0, blockIdx.y, blk.bkv);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      CONSUMER_REGS));
  const int w = threadIdx.x / WG;
  if (w >= blk.nlive) return;  // no live row
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int fw = blk.f0 + 64 * w;
  const uint32_t qw = base + w * Gm::Q_WG;
  load_q<D>(gbase + w * Gm::Q_WG, a, fw, blk.rows, tid);
  fence_async_smem();
  named_sync(1 + w, WG);

  // the thread's two rows (of the wgmma accumulator layout) and the keys
  // some row of this consumer sees
  int qlim[2], wlo[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = fw + warp * 16 + lane / 4 + 8 * j;
    const int qpos = blk.qoff + f / a.G;
    qlim[j] = f < blk.rows ? min(qpos, blk.klen - 1) : -1;
    wlo[j] = window_floor(a, qpos);
  }
  const int t_last = min((fw + 63) / a.G, a.T - 1);
  const int wkend = max(0, min(blk.qoff + t_last + 1, blk.klen));
  const int wkmin = window_start(a, blk.qoff + fw / a.G);
  // a tile needs no mask when it lies under every live row's causal limit
  // and above every live row's window floor
  const int wq_min = min(blk.qoff + fw / a.G, blk.klen - 1);
  const int wl_max = window_floor(a, blk.qoff + t_last);

  float o[PANELS][PW / 2];
#pragma unroll
  for (int p = 0; p < PANELS; ++p) {
#pragma unroll
    for (int i = 0; i < PW / 2; ++i) o[p][i] = 0.f;
  }
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int g = 0; g < blk.tiles; ++g) {
    const int s = g % STAGES;
    const int k0 = blk.kbeg + g * BN;
    mbar_wait(full(s), (g / STAGES) & 1);
    if constexpr (PAGED && !QUANT) {
      // V rows that hold no visible key contribute exactly nothing: the
      // pieces wholly before kfirst, which were not loaded (the first
      // tile's [0, lead)), and the rows at and past kend (the last tile's).
      // Kept apart from the dense pool's loop below: one loop for both
      // scheduled the dense body's main loop otherwise and took 8 % more
      // time at row 1's suffix prefill on an H100.
      const int lead = max(0, blk.kfirst - k0) / a.box * a.box;
      if (lead > 0 || k0 + BN > blk.kend) {
        constexpr int CHUNKS = PANELS * Gm::SWB / 16;
        const int tail = min(BN, max(blk.kend - k0, lead));
        unsigned char* vs = gbase + v_stage(s);
        for (int i = w * WG + tid; i < (lead + BN - tail) * CHUNKS;
             i += WG * blk.nlive) {
          const int r = i / CHUNKS;
          const int row = r < lead ? r : tail + r - lead;
          const int c = i % CHUNKS;
          *reinterpret_cast<uint4*>(
              vs + (c / (Gm::SWB / 16)) * Gm::T_PANEL + row * Gm::SWB +
              (c % (Gm::SWB / 16)) * 16) = make_uint4(0, 0, 0, 0);
        }
        fence_async_smem();
        named_sync(3, WG * blk.nlive);
      }
    } else if (!QUANT && k0 + BN > blk.kend) {
      // the last tile: V rows at and past kend contribute exactly nothing
      constexpr int CHUNKS = PANELS * Gm::SWB / 16;
      const int first = blk.kend - k0;
      unsigned char* vs = gbase + v_stage(s);
      for (int i = w * WG + tid; i < (BN - first) * CHUNKS;
           i += WG * blk.nlive) {
        const int row = first + i / CHUNKS;
        const int c = i % CHUNKS;
        *reinterpret_cast<uint4*>(
            vs + (c / (Gm::SWB / 16)) * Gm::T_PANEL + row * Gm::SWB +
            (c % (Gm::SWB / 16)) * 16) = make_uint4(0, 0, 0, 0);
      }
      fence_async_smem();
      named_sync(3, WG * blk.nlive);
    }
    if (k0 < wkend && k0 + BN > wkmin) {
      // S = Q K^T
      float sc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk * 16 / PW;
        const int within = (kk * 16 % PW) * 2;
        const uint64_t da = smem_desc(qw + p * Gm::Q_PANEL + within, 16,
                                      8 * Gm::SWB, Gm::LAYOUT);
        const uint64_t db =
            smem_desc(base + k_stage(s) + p * Gm::T_PANEL + within, 16,
                      8 * Gm::SWB, Gm::LAYOUT);
        if constexpr (BN == 128) {
          wgmma_ss_n128(sc, da, db, kk > 0);
        } else if constexpr (BN == 64) {
          wgmma_ss_n64(sc, da, db, kk > 0);
        } else {
          wgmma_ss_n32(sc, da, db, kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // online softmax on the registers; the mask only where some live row
      // of this consumer has a dead key in the tile
      float alpha[2];
      const float* ksc =
          reinterpret_cast<const float*>(gbase + SC_OFF + s * Gm::SCALES);
      if (k0 + BN - 1 > wq_min || k0 <= wl_max) {
        softmax_tile<BN, true, SOFTCAP, QUANT>(sc, m, l, alpha, a, k0, lane,
                                               qlim, wlo, ksc);
      } else {
        softmax_tile<BN, false, SOFTCAP, QUANT>(sc, m, l, alpha, a, k0, lane,
                                                qlim, wlo, ksc);
      }
      if constexpr (QUANT) {
        // the V scale multiplies P's columns after the row sum
        const float* vsc = ksc + BN;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
          const float2 vs =
              *reinterpret_cast<const float2*>(vsc + c * 8 + 2 * (lane & 3));
          sc[4 * c] *= vs.x;
          sc[4 * c + 1] *= vs.y;
          sc[4 * c + 2] *= vs.x;
          sc[4 * c + 3] *= vs.y;
        }
      }
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
#pragma unroll
        for (int i = 0; i < PW / 2; ++i) o[p][i] *= alpha[(i >> 1) & 1];
      }
      // P in bf16 as wgmma's A fragments, 16 keys each: the accumulator
      // layout of two 8-key groups is the A layout of one 16-key step
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }
      }

      // O += P V
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PANELS; ++p) reg_fence(o[p]);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          const uint64_t db = smem_desc(
              base + v_stage(s) + p * Gm::T_PANEL + kk * 16 * Gm::SWB,
              8 * Gm::SWB, 8 * Gm::SWB, Gm::LAYOUT);
          if constexpr (PW == 64) {
            wgmma_rs_n64(o[p], pa[kk], db);
          } else {
            wgmma_rs_n32(o[p], pa[kk], db);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < PANELS; ++p) reg_fence(o[p]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // normalize and write. A sink logit joins the normalization and is then
  // dropped; with no live key m = -1e30 and l = 0, so the row gives 0.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = fw + warp * 16 + lane / 4 + 8 * j;
    if (f >= blk.rows) continue;
    const int head = blockIdx.y * a.G + f % a.G;
    float inv = l[j] > 0.f ? 1.f / l[j] : 0.f;
    if (a.sinks != nullptr) {  // m is in the log2 domain
      const float snk = a.sinks[head] * LOG2E;
      const float m2 = fmaxf(m[j], snk);
      const float keep = ex2(m[j] - m2);
      inv = keep / (l[j] * keep + ex2(snk - m2));
    }
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

// ------------------------------------------------------------ host ---

// K or V as a 4-d tensor map: D innermost, then the key, head and pool-row
// dimensions in the order of their strides (elements), boxes of PW columns
// by `box` keys in the body's swizzle (int8: whole rows of D bytes by BN
// keys, unswizzled, for the staging ring). The dense pool has S keys and B
// rows; a paged arena `page` keys (the row in page) and P rows (the page
// id). pos[i] receives the coordinate that carries index i (0 key, 1 head,
// 2 row). False where TMA cannot take the tensor (the wrapper checks
// alignment and strides first).
template <int D, typename KV>
bool encode_kv_map(CUtensorMap* map, int (&pos)[3], const void* base,
                   long long s_key, long long s_head, long long s_row,
                   int keys, int Hkv, unsigned long long rows, int box_keys) {
  using Gm = Geometry<D, KV>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  struct Dim {
    cuuint64_t n;
    long long stride;
    int index;
  } d[3] = {{static_cast<cuuint64_t>(keys > 1 ? keys : 1), s_key, 0},
            {static_cast<cuuint64_t>(Hkv > 1 ? Hkv : 1), s_head, 1},
            {rows, s_row, 2}};
  for (int i = 1; i < 3; ++i) {
    for (int j = i; j > 0 && d[j - 1].stride > d[j].stride; --j) {
      std::swap(d[j - 1], d[j]);
    }
  }
  cuuint64_t dims[4] = {D, d[0].n, d[1].n, d[2].n};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {Gm::QUANT ? D : Gm::PW, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    if (d[i].stride < 0) return false;
    strides[i] = static_cast<cuuint64_t>(d[i].stride) * sizeof(KV);
    pos[d[i].index] = i + 1;
    if (d[i].index == 0) box[i + 1] = static_cast<cuuint32_t>(box_keys);
  }
  return encode(map,
                Gm::QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Gm::QUANT       ? CU_TENSOR_MAP_SWIZZLE_NONE
                : Gm::PW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The fields a paged launch needs: pages a multiple of 16 rows, S the
// table's width in keys, and a box that divides the tile of KV (int8 tiles
// are not bf16's) and the page (so that a piece never crosses a page) in
// whole 16-row steps (whole periods of the panels' swizzle; int8: a box of
// at least 16 rows of D >= 64 bytes meets TMA's alignment); and int8 the
// scales. The options (window, sliding or chunked; softcap; sinks) are the
// dense body's: a chunk boundary may fall inside a page, as the piece that
// holds the block's oldest visible key is loaded whole and its earlier keys
// are masked (bf16: and their V rows zeroed; int8: their scales 0).
template <int D, typename KV>
bool paged_args_ok(const FlashArgs& a) {
  constexpr int BN = Geometry<D, KV>::BN;
  return a.page_table != nullptr && a.kv_slot == nullptr && a.NP > 0 &&
         a.P > 0 && a.page > 0 && a.page % 16 == 0 &&
         static_cast<long long>(a.NP) * a.page == a.S && a.box > 0 &&
         a.box % 16 == 0 && BN % a.box == 0 && a.page % a.box == 0 &&
         (!Geometry<D, KV>::QUANT ||
          (a.k_scale != nullptr && a.v_scale != nullptr));
}

// Encode the launch's K and V maps and launch the body on `stream`. The
// pool's row count is not in the argument block: without kv_slot it is B;
// with it the row is the caller's word, read on the device, and the map's
// row dimension is left open. A paged arena has P rows of `page` keys.
template <int D, int STAGES, bool SOFTCAP, typename KV = bf16,
          bool PAGED = false>
cudaError_t launch(const FlashArgs& a, int B, int Hkv, cudaStream_t stream) {
  constexpr int bytes = Geometry<D, KV>::bytes(STAGES);
  static_assert(bytes <= SMEM_LIMIT, "the ring does not fit shared memory");
  if constexpr (PAGED) {
    if (!paged_args_ok<D, KV>(a)) return cudaErrorInvalidValue;
  }
  static std::atomic<int> raised[64];
  cudaError_t err = raise_smem_limit(
      flash_sm90_fwd<D, STAGES, SOFTCAP, KV, PAGED>, bytes, raised);
  if (err != cudaSuccess) return err;
  const unsigned long long rows =
      PAGED                ? static_cast<unsigned long long>(a.P)
      : a.kv_slot != nullptr ? (1ull << 31)
                             : static_cast<unsigned long long>(B);
  const int keys = PAGED ? a.page : a.S;
  const int box = PAGED ? a.box : Geometry<D, KV>::BN;
  CUtensorMap kmap, vmap;
  TmaOrder ord;
  if (!encode_kv_map<D, KV>(&kmap, ord.k, a.k, a.ks, a.kh, a.kb, keys, Hkv,
                            rows, box) ||
      !encode_kv_map<D, KV>(&vmap, ord.v, a.v, a.vs, a.vh, a.vb, keys, Hkv,
                            rows, box)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((a.T * a.G + ROWS - 1) / ROWS, Hkv, B);
  flash_sm90_fwd<D, STAGES, SOFTCAP, KV, PAGED>
      <<<grid, THREADS, bytes, stream>>>(a, kmap, vmap, ord);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace lmc
