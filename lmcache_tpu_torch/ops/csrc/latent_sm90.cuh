// The Hopper body of the MLA latent-attention kernels: the dense kernel
// (latent_attention.cu, row 8) and the two paged kernels
// (paged_latent_attention.cu, rows 9 and 10, and row 10's key-split
// decode). TMA, wgmma, and the scores, probabilities and output accumulator
// in registers.
//
// What the TPU kernels compute (lmcache_tpu/ops/latent_attention.py::
// _latent_kernel, lmcache_tpu/ops/paged_latent_attention.py::
// _paged_latent_kernel and ::_paged_latent_dma_kernel): absorbed MLA, one
// latent stream shared by all H heads. q_full [B, T, H, C] (bf16, any
// strides with unit stride along C) against the sequence's latent rows: a
// layer's slice of the dense pool [B, S, >= C], or of the paged arena
// [P, page, >= C] named by page_table [B, NP] (both read in place; only the
// first C columns of a row are read). Scores q_full . row, the value
// row[:r], the mask
//     kpos <= min(q_offset[b] + t, kv_len[b] - 1),
// an online softmax in fp32, P rounded to bf16 before the value product,
// out [B, T, H, r] bf16 (the latent-space context); a row that sees no key
// gives 0. int8 rows carry one fp32 scale a token, which multiplies the
// score column (times the score scale) and, after the row sum, the
// probability column before P is rounded to bf16. Page-table entries past a
// sequence's live slots are never read; a page id outside the pool reads as
// zeros (TMA's out-of-bounds fill; int8: scale 0).
//
// Design, after the public FlashMLA kernel's shape, per block of BM = 64
// rows of one sequence, the (token, head) pairs flattened token-major
// (f = t * H + h): 64 rows are 64 / H tokens (a few at H 16, one at H 128),
// so a block's causal range ends within a few keys of its first token's
// and fewer tiles are half dead than with head-major rows (f = h * T + t,
// the TPU kernels' order, where a block spans 64 tokens); the output rows
// are contiguous in [B, T, H, r]. Three warpgroups:
// - warpgroup 2, the producer, gives its registers away (setmaxnreg); its
//   first warp keeps TMA loads of key tiles of BN latent rows in flight
//   through a ring of STAGES (mbarrier full and empty barriers), each tile
//   as 9 panels of 64 columns in a 128-byte swizzle (a narrower latent
//   reads zeros past C: every product has the same unrolled shape); the
//   tiles end at the block's last visible key.
//   - dense pool (row 8): one box of BN keys a panel, at (key, sequence).
//   - paged arena (rows 9 and 10): the arena is a 3-d map [P, page, C] and
//     each tile is loaded as page pieces, a box of `box` rows a panel for
//     each piece at (row in page, page id), where box is the largest
//     divisor of the tile that also divides the page (the whole tile at
//     page 64 and tiles of 32; two boxes at page 16; a page a box when the
//     tile is the page). Pieces at and past the block's last visible key
//     are not loaded, so dead slots are never touched. The warp's 32 lanes
//     hold 32 consecutive live page ids of the block's table (one load a
//     lane, refreshed when the walk leaves them); lane 0 issues the loads.
// - warpgroups 0 and 1, the consumers, hold the same 64 rows; Q [64, C] is
//   loaded once into shared memory in panels of 64 columns (zero past C).
//   Each owns half of O's columns (256 of 512: O[64, 256] fp32 is 128
//   registers a thread). They take the tiles in turn: the owner of tile g
//   (warpgroup g % 2) runs S = Q K^T as wgmma over the depth C (N = BN, as
//   products of 64, 32 and 16 columns), the online softmax on S in
//   registers (quad shuffles, ex2 on log2-scaled scores, the mask as
//   selects where some row has a dead key), publishes P (bf16) and the
//   rows' (alpha, m, l) through shared memory, and runs O += P V on its
//   half with P as wgmma's register operand; the other warpgroup rescales
//   its half by alpha and runs O += P V from the shared P. V is the first
//   r columns of the same tile, read MN-major (the transpose bit), one
//   wgmma a panel of 64 columns. A warpgroup issues the product S of its
//   own next tile before it takes the other's P, so each one's softmax
//   runs while the other's products are in flight (with a ring of one
//   stage it first finishes the other's tile, which frees the stage); every
//   product is waited for in the straight code that issued it (no product
//   in flight across a branch, which would make ptxas serialize them). P
//   and the statistics need one buffer: the one reader of P_g is the owner
//   of g + 1, which writes P_{g+1} only after its product with P_g is done.
// - TMA reads whole boxes: latent rows at and past kend inside the pool or
//   page are loaded (rows past S, and pages outside the pool, come as
//   zeros; pieces not loaded keep what the stage held). Masked scores are
//   selects, so K's tail is harmless, but 0 * NaN is NaN, so each consumer
//   zeroes its half of V's tail rows in the last tile before its product
//   with it.
// - int8 rows: the symbols are converted exactly to bf16 on the chip (Q
//   stays bf16, as in the TPU kernels, and wgmma has no bf16 x int8 form).
//   TMA brings the int8 tiles (the same pieces) into a staging ring, the
//   producer warpgroup's three other warps write them as bf16 panels, zero
//   at and past kend, with the tile's scales (plain loads, one key a
//   thread, a tile ahead; 0 past kend and for a page outside the pool).
//   At an odd page size a piece is one int8 row of 64 bytes a panel, which
//   cannot land on TMA's 128-byte shared-memory alignment: there the
//   converting warps read the rows through the page table themselves.
// - Key split (row 10's decode, LatentArgs::split > 0): the grid's second
//   axis takes the sequence's keys in splits at absolute multiples of
//   `split` (a multiple of BN); a block runs the same body over its split
//   and writes the unnormalized fp32 O of its rows and (m, l) (m in the
//   natural-log domain) to the partials; a split past the block's keys
//   writes (m = -1e30, l = 0). The combine kernel (combine.cuh) merges a
//   row's partials in split order.
// - Budget (227 KB = 232,448 bytes; Geometry below), Q 73,728 bytes, P a
//   panel of 4,096 bytes for every 32 keys of the tile, statistics 1,024,
//   the ring as deep as fits (at most 8 stages):
//   - tiles of 32 keys (rows 8 and 10): Q + 4 stages x 36,864 + P 4,096 +
//     statistics 1,024 = 226,304 bytes (bf16), or Q + 3 stages + 2 int8
//     staging stages x 18,432 + P + statistics + scales 384 = 226,688
//     bytes (int8). Tiles of 64 keys would leave 2 stages and no room for
//     an int8 staging stage, and with 2 stages a tile's load is not issued
//     until both consumers are done with the tile two back (on an H100
//     that measured slower, most of all in int8).
//   - a page a tile (row 9): page 16: 8 stages x 18,432 (bf16; int8 7
//     stages and 2 staging stages of 9,216); page 64: 2 stages x 73,728
//     + P 8,192 (int8: 1 stage and 2 staging stages of 36,864); the
//     largest pages that fit are 112 (bf16: Q + 129,024 + P 16,384 =
//     220,160 bytes, one stage) and 80 (int8: Q + 92,160 + one staging
//     stage of 46,080 + P 12,288 + scales = 225,600 bytes).
// - No float atomics and a fixed order of every sum: two launches on the
//   same inputs give the same bits, and split points that depend on the
//   key position alone give a decode row the same bits in any batch.
//
// Bound on an H100: a prefill of T tokens does 2 * H * (C + r) operations a
// live (token, key) pair on about 2 * S * C bytes of latents, far above the
// card's ~295 FLOP/byte ridge: bound by the tensor-core operations, which
// wgmma reaches. A decode step (T = 1) does 2 * H * (C + r) / (2 * C), ~30
// operations a latent byte at H 16, and is bound by the latent bytes: one
// block a sequence at H <= 64 would walk all of its keys on one SM, so
// row 10's decode splits the keys and puts B * S / split blocks on the
// card (at 16 live rows of 64 a wgmma wastes three quarters of the tensor
// cores but stays above the bytes bound).

#pragma once

#include <type_traits>

#include "latent_args.cuh"
#include "sm90_ptx.cuh"

namespace lmc {
namespace latent {

using namespace sm90;

constexpr int WG = 128;           // threads of a warpgroup
constexpr int BM = 64;            // (token, head) rows a block
constexpr int THREADS = 3 * WG;   // two consumers and the producer
constexpr int CONVERTERS = WG - 32;  // int8: the producer's other warps
constexpr int CONVERT_VECTORS = 4;   // 16-byte vectors in flight a thread
constexpr int MAX_C = 576;        // latent width (every preset's)
constexpr int MAX_R = 512;        // value width (every preset's rank)
constexpr int PANELS = MAX_C / 64;
constexpr int O_PANELS = MAX_R / 128;  // panels of 64 columns a consumer
constexpr int MAX_STAGES = 8;
constexpr float LN2 = 0.6931471805599453f;

// ring stages of `stage` bytes that fit beside `fixed` bytes (at most
// MAX_STAGES; below 1 where not even one fits)
constexpr int ring_stages(int fixed, int stage) {
  return (SMEM_LIMIT - fixed) / stage < MAX_STAGES
             ? (SMEM_LIMIT - fixed) / stage
             : MAX_STAGES;
}

template <typename KV, int BN_>
struct Geometry {
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int BN = BN_;               // keys a tile
  static_assert(BN % 16 == 0 && BN <= 128, "tiles of 16 to 128 keys");
  static constexpr int PANEL = BN * 128;      // a tile's 64 columns, bf16
  static constexpr int TILE = PANELS * PANEL;
  static constexpr int Q_PANEL = BM * 128;
  static constexpr int P_SWB = 64;            // bytes a row of P: 64B swizzle
  static constexpr int P_PANEL = BM * P_SWB;  // 32 keys of P
  static constexpr int P_PANELS = (BN + 31) / 32;
  static constexpr int STAGE8 = QUANT ? PANELS * BN * 64 : 0;
  static constexpr int ALIGN = 1024;  // the swizzle pattern's period
  static constexpr int SCALES = QUANT ? BN * 4 : 0;  // a stage's scales
  static constexpr int FIXED = ALIGN + PANELS * Q_PANEL +
                               P_PANELS * P_PANEL + BM * 16 +
                               8 * (2 * MAX_STAGES + 5);
  // int8 rows keep two staging stages unless that costs a bf16 stage
  static constexpr int STAGES8 =
      QUANT ? (ring_stages(FIXED + 2 * STAGE8, TILE + SCALES) >=
                       ring_stages(FIXED + STAGE8, TILE + SCALES)
                   ? 2
                   : 1)
            : 0;
  static constexpr int STAGES =  // bf16 tiles in the ring
      ring_stages(FIXED + STAGES8 * STAGE8, TILE + SCALES);
  static constexpr bool FITS = STAGES >= 1;
  // offsets from the aligned base: Q, the bf16 ring, the staging ring, P,
  // the row statistics [BM][4], the scales, the barriers
  static constexpr int KV_OFF = PANELS * Q_PANEL;
  static constexpr int K8_OFF = KV_OFF + STAGES * TILE;
  static constexpr int P_OFF = K8_OFF + STAGES8 * STAGE8;
  static constexpr int ST_OFF = P_OFF + P_PANELS * P_PANEL;
  static constexpr int SC_OFF = ST_OFF + BM * 16;
  static constexpr int BAR_OFF = SC_OFF + STAGES * SCALES;
  static constexpr int BARS = 2 * STAGES + 2 * STAGES8 + 1;
  static constexpr int BYTES = ALIGN + BAR_OFF + 8 * BARS;
  // registers a thread (setmaxnreg): 128 * producer + 256 * consumer
  // <= 65,536
  static constexpr int PRODUCER_REGS = QUANT ? 56 : 40;
  static constexpr int CONSUMER_REGS = QUANT ? 224 : 232;
};

// the swizzle of a row of SWB bytes (128 or 64): 16-byte chunks XORed with
// the row's low bits, as TMA and the wgmma descriptors lay them out
template <int SWB>
__device__ __forceinline__ int swz(int off) {
  return off ^ (((off >> 7) & (SWB / 16 - 1)) << 4);
}

// S[:, N0:BN] (+)= A B over one step of depth 16, as products of 64, 32 and
// 16 columns: the accumulator of N columns is the first N / 2 registers of
// the thread's row pair, so the pieces' registers follow one another.
// b_addr: the K-major tile panel at the step's depth.
template <int BN, int N0 = 0>
__device__ __forceinline__ void s_product(float (&sc)[BN / 2], uint64_t da,
                                          uint32_t b_addr, int acc) {
  if constexpr (N0 < BN) {
    constexpr int N = BN - N0 >= 64 ? 64 : (BN - N0 >= 32 ? 32 : 16);
    const uint64_t db = smem_desc(b_addr + N0 * 128, 16, 1024, 1);
    auto& d = *reinterpret_cast<float(*)[N / 2]>(&sc[N0 / 2]);
    if constexpr (N == 64) {
      wgmma_ss_n64(d, da, db, acc);
    } else if constexpr (N == 32) {
      wgmma_ss_n32(d, da, db, acc);
    } else {
      wgmma_ss_n16(d, da, db, acc);
    }
    s_product<BN, N0 + N>(sc, da, b_addr, acc);
  }
}

// The online-softmax update of a thread's two rows over one tile of scores
// in registers, in the log2 domain: element i is row (i >> 1) & 1 of the
// thread's pair, key k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1); a row's
// max and sum are reduced over its quad. MASK: keys past a row's limit are
// selects to -1e30 and give 0. QUANT: sc times the key's scale (0 past
// kend) before, and P times it after the row sum. Leaves P (fp32) in sc.
template <int BN, bool MASK, bool QUANT>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale,
                                             int k0, int lane,
                                             const int (&qlim)[2],
                                             const float* ksc) {
  const float scale2 = scale * LOG2E;
  float ks[BN / 4];  // the thread's keys' scales, a pair per 8 keys
  if constexpr (QUANT) {
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const float2 v =
          *reinterpret_cast<const float2*>(ksc + c * 8 + 2 * (lane & 3));
      ks[2 * c] = v.x;
      ks[2 * c + 1] = v.y;
    }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int j = (i >> 1) & 1;
    float x = QUANT ? sc[i] * (ks[2 * (i >> 2) + (i & 1)] * scale2)
                    : sc[i] * scale2;
    if (MASK) {
      const int kpos = k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
      x = kpos <= qlim[j] ? x : NEG_INF;
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
    float p = !MASK || sc[i] > 0.5f * NEG_INF ? ex2(sc[i] - m[j]) : 0.f;
    sum[j] += p;  // the row sum comes before the token's scale
    if (QUANT) p *= ks[2 * (i >> 2) + (i & 1)];
    sc[i] = p;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 1);
    sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 2);
    l[j] = alpha[j] * l[j] + sum[j];
  }
}

// The scale of key k (< kend) of sequence b: dense [B, S], or paged
// [P, page] through the page table (0 for a page outside the pool).
template <bool PAGED>
__device__ __forceinline__ float key_scale(const LatentArgs& a, int b,
                                           int k) {
  if constexpr (PAGED) {
    const int pid = a.page_table[static_cast<long long>(b) * a.NP +
                                 k / a.page];
    if (pid < 0 || pid >= a.P) return 0.f;
    return a.kv_scale[pid * a.sb + static_cast<long long>(k % a.page) * a.ss];
  } else {
    return a.kv_scale[b * a.sb + static_cast<long long>(k) * a.ss];
  }
}

// int8 rows: the converting warps turn each staged int8 tile into the bf16
// panels and scales of its ring stage, zero at and past kend; the stage is
// signalled full once the three warps are done, and the staging stage free.
// The next tile's scales are loaded into registers while this tile is
// converted, so that their device-memory latency does not hold up every
// tile.
template <bool PAGED, int BN>
__device__ __forceinline__ void convert_tiles(
    const LatentArgs& a, int b, int klo, int tiles, int kend,
    unsigned char* gbase, uint32_t bar_full, uint32_t bar_empty,
    uint32_t bar_full8, uint32_t bar_empty8, int ct) {
  using Gm = Geometry<i8, BN>;
  constexpr int STAGES = Gm::STAGES;
  static_assert(BN <= CONVERTERS, "a scale a converting thread");
  // tile g's scale of this thread's key, 0 at and past kend
  auto fetch = [&](int g) {
    const int k = klo + g * BN + ct;
    return ct < BN && k < kend ? key_scale<PAGED>(a, b, k) : 0.f;
  };
  // pages of an odd size: boxes of one int8 row (64 bytes) cannot land
  // on TMA's 128-byte alignment, so these warps read the rows themselves
  const bool direct = PAGED && (a.box & 1);
  const i8* rows = static_cast<const i8*>(a.kv);
  float next = tiles > 0 ? fetch(0) : 0.f;
  for (int g = 0; g < tiles; ++g) {
    const int s = g % STAGES, s8 = g % Gm::STAGES8;
    const int k0 = klo + g * BN;
    const int live = kend - k0;  // keys of the tile below kend
    const float cur = next;
    if (g + 1 < tiles) next = fetch(g + 1);
    if (g >= STAGES) mbar_wait(bar_empty + 8 * s, ((g / STAGES) - 1) & 1);
    if (!direct) mbar_wait(bar_full8 + 8 * s8, (g / Gm::STAGES8) & 1);
    const unsigned char* src = gbase + Gm::K8_OFF + s8 * Gm::STAGE8;
    unsigned char* dst = gbase + Gm::KV_OFF + s * Gm::TILE;
    // CONVERT_VECTORS loads in flight, then their conversions and stores
    // (rows at and past kend, loaded or not, become 0)
    constexpr int n = PANELS * BN * 4;  // 16-byte vectors of the tile
    for (int i0 = ct; i0 < n; i0 += CONVERT_VECTORS * CONVERTERS) {
      uint4 raw[CONVERT_VECTORS];
#pragma unroll
      for (int u = 0; u < CONVERT_VECTORS; ++u) {
        const int i = i0 + u * CONVERTERS;
        raw[u] = make_uint4(0, 0, 0, 0);
        const int row = (i / 4) % BN;
        if (i >= n || row >= live) continue;
        if (!direct) {
          raw[u] = *reinterpret_cast<const uint4*>(src + i * 16);
          continue;
        }
        // symbols 16 (i % 4) of panel i / (4 BN), through the page table
        // (zero past C and for a page outside the pool)
        const int k = k0 + row;
        const int c = (i / (BN * 4)) * 64 + (i % 4) * 16;
        const int pid = a.page_table[static_cast<long long>(b) * a.NP +
                                     k / a.page];
        if (c < a.C && pid >= 0 && pid < a.P) {
          raw[u] = *reinterpret_cast<const uint4*>(
              rows + pid * a.kb + static_cast<long long>(k % a.page) * a.ks +
              c);
        }
      }
#pragma unroll
      for (int u = 0; u < CONVERT_VECTORS; ++u) {
        const int i = i0 + u * CONVERTERS;
        if (i >= n) break;
        // vector i: panel i / (4 BN), row (i / 4) % BN, symbol 16 (i % 4)
        const int off = ((i / 4) % BN) * 128 + (i % 4) * 32;
        unsigned char* d = dst + (i / (BN * 4)) * Gm::PANEL;
        uint4 lo, hi;
        i8x16_to_bf16(raw[u], lo, hi);
        *reinterpret_cast<uint4*>(d + swz<128>(off)) = lo;
        *reinterpret_cast<uint4*>(d + swz<128>(off + 16)) = hi;
      }
    }
    if (ct < BN) {
      reinterpret_cast<float*>(gbase + Gm::SC_OFF)[s * BN + ct] = cur;
    }
    fence_async_smem();  // the panels are read by wgmma (async proxy)
    __syncwarp();
    if (ct % 32 == 0) {
      if (!direct) mbar_arrive(bar_empty8 + 8 * s8);
      mbar_arrive(bar_full + 8 * s);
    }
  }
}

// KV: bf16 or int8 rows; PAGED: the arena through the page table (else the
// dense pool); BN: keys a tile.
template <typename KV, bool PAGED, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    latent_sm90_fwd(const LatentArgs a,
                    __grid_constant__ const CUtensorMap kvmap) {
  using Gm = Geometry<KV, BN>;
  constexpr bool QUANT = Gm::QUANT;
  constexpr int STAGES = Gm::STAGES;
  // a ring of one stage: a consumer finishes the other's tile, which frees
  // the stage, before it waits for its own
  constexpr bool SERIAL = STAGES == 1;
  extern __shared__ unsigned char smem_raw[];
  // 1024-aligned base: generic pointer and shared address
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + Gm::ALIGN - 1) & ~uint32_t(Gm::ALIGN - 1);
  unsigned char* gbase = smem_raw + (base - raw);
  auto stage = [&](int s) { return base + Gm::KV_OFF + s * Gm::TILE; };
  auto full = [&](int s) { return base + Gm::BAR_OFF + 8 * s; };
  auto empty = [&](int s) { return base + Gm::BAR_OFF + 8 * (STAGES + s); };
  auto full8 = [&](int s) {
    return base + Gm::BAR_OFF + 8 * (2 * STAGES + s);
  };
  auto empty8 = [&](int s) {
    return base + Gm::BAR_OFF + 8 * (2 * STAGES + Gm::STAGES8 + s);
  };
  const uint32_t pfull = base + Gm::BAR_OFF + 8 * (Gm::BARS - 1);

  // the block's rows, its split, and the keys [klo, kend) that some row of
  // it sees in the split
  const int b = blockIdx.z;
  const int R = a.H * a.T;
  // the last rows have the most keys: schedule them first
  const int f0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int qoff = a.q_offset[b];
  const int klen = min(a.kv_len[b], a.S);
  const int t_first = f0 / a.H;
  const int t_last = min((f0 + BM - 1) / a.H, a.T - 1);
  const bool split = a.split > 0;
  const int klo = split ? blockIdx.y * a.split : 0;
  int kend = max(0, min(qoff + t_last + 1, klen));
  if (split) kend = min(kend, klo + a.split);
  const int tiles = kend > klo ? (kend - klo + BN - 1) / BN : 0;
  // partials: row f of (b, split) at this index
  const long long part0 =
      (static_cast<long long>(b) * gridDim.y + blockIdx.y) * R;

  if (split && tiles == 0) {  // an empty partial
    for (int i = threadIdx.x; i < BM && f0 + i < R; i += THREADS) {
      a.part_ml[2 * (part0 + f0 + i)] = NEG_INF;
      a.part_ml[2 * (part0 + f0 + i) + 1] = 0.f;
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // full: the TMA's transaction (bf16) or the three converting warps
      mbar_init(full(s), QUANT ? CONVERTERS / 32 : 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < Gm::STAGES8; ++s) {
      mbar_init(full8(s), 1);
      mbar_init(empty8(s), CONVERTERS / 32);
    }
    mbar_init(pfull, 4);  // lane 0 of each warp of the tile's owner
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    // ---- producer: its first warp (dense: one thread) keeps the ring
    // (int8: the staging ring) full; int8: the other three warps convert
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Gm::PRODUCER_REGS));
    const int pt = threadIdx.x - 2 * WG;
    // int8 pages of an odd size: the converting warps read the rows
    if (pt < (PAGED ? 32 : 1) && !(QUANT && PAGED && (a.box & 1))) {
      // bytes of a row of a panel, and from one panel to the next
      constexpr int ROW = QUANT ? 64 : 128;
      constexpr int PSTRIDE = QUANT ? BN * 64 : Gm::PANEL;
      // paged: 32 consecutive live page ids of the block, one a lane,
      // from slot `win` on
      const int* table =
          PAGED ? a.page_table + static_cast<long long>(b) * a.NP : nullptr;
      const int slot_end = PAGED ? (kend + a.page - 1) / a.page : 0;
      int win = -0x40000000, ids = 0;
      for (int g = 0; g < tiles; ++g) {
        const int k0 = klo + g * BN;
        uint32_t dst, bar;
        if constexpr (QUANT) {
          const int s8 = g % Gm::STAGES8;
          if (g >= Gm::STAGES8) {
            mbar_wait(empty8(s8), ((g / Gm::STAGES8) - 1) & 1);
          }
          dst = base + Gm::K8_OFF + s8 * Gm::STAGE8;
          bar = full8(s8);
        } else {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(empty(s), ((g / STAGES) - 1) & 1);
          dst = stage(s);
          bar = full(s);
        }
        if constexpr (!PAGED) {
          mbar_expect_tx(bar, PANELS * BN * ROW);
          for (int p = 0; p < PANELS; ++p) {
            tma_load_3d(dst + p * PSTRIDE, &kvmap, bar, p * 64, k0, b);
          }
        } else {
          // the pieces of `box` rows below kend, each a box a panel at
          // (row in its page, page id)
          const int d = a.box;
          const int pieces = (min(BN, kend - k0) + d - 1) / d;
          if (pt == 0) mbar_expect_tx(bar, PANELS * pieces * d * ROW);
          for (int j = 0; j < pieces; ++j) {
            const int kj = k0 + j * d;
            const int slot = kj / a.page;
            if (slot < win || slot >= win + 32) {  // the same on every lane
              win = slot;
              ids = slot + pt < slot_end ? table[slot + pt] : 0;
            }
            const int pid = __shfl_sync(0xffffffffu, ids, slot - win);
            if (pt == 0) {
              for (int p = 0; p < PANELS; ++p) {
                tma_load_3d(dst + p * PSTRIDE + j * d * ROW, &kvmap, bar,
                            p * 64, kj % a.page, pid);
              }
            }
          }
        }
      }
    } else if constexpr (QUANT) {
      if (pt >= 32) {
        convert_tiles<PAGED, BN>(a, b, klo, tiles, kend, gbase, full(0),
                                 empty(0), full8(0), empty8(0), pt - 32);
      }
    }
    return;
  }

  // ---- consumers: the same 64 rows, half of O's columns each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      Gm::CONSUMER_REGS));
  const int w = threadIdx.x / WG;
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32;
  const int lane = tid % 32;
  {
    // Q [64, C] into panels of 64 columns, zero past C and past the rows
    const bf16* qbase = static_cast<const bf16*>(a.q) + b * a.qb;
    for (int i = threadIdx.x; i < BM * PANELS * 8; i += 2 * WG) {
      const int rr = i / (PANELS * 8);
      const int c = (i % (PANELS * 8)) * 8;
      const int f = f0 + rr;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (f < R && c < a.C) {
        val = *reinterpret_cast<const uint4*>(qbase + (f / a.H) * a.qt +
                                              (f % a.H) * a.qh + c);
      }
      *reinterpret_cast<uint4*>(gbase + (c / 64) * Gm::Q_PANEL +
                                swz<128>(rr * 128 + (c % 64) * 2)) = val;
    }
    fence_async_smem();
    named_sync(1, 2 * WG);
  }

  // the thread's two rows of the wgmma accumulator layout; a tile needs no
  // mask when it lies under the first token's limit (every live row's)
  int qlim[2];
  int r_of[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    r_of[j] = warp * 16 + lane / 4 + 8 * j;
    const int f = f0 + r_of[j];
    qlim[j] = f < R ? min(qoff + f / a.H, klen - 1) : -1;
  }
  const int q_min = min(qoff + t_first, klen - 1);

  float o[O_PANELS][32];
#pragma unroll
  for (int p = 0; p < O_PANELS; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  }
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float* stats = reinterpret_cast<float*>(gbase + Gm::ST_OFF);
  unsigned char* pg = gbase + Gm::P_OFF;
  const uint32_t ps = base + Gm::P_OFF;

  // bf16: V's rows at and past kend in the last tile, this consumer's half,
  // to zero before its product with them
  auto zero_tail = [&](int g) {
    const int first = kend - (klo + g * BN);
    if (QUANT || first >= BN) return;
    unsigned char* t = gbase + Gm::KV_OFF + (g % STAGES) * Gm::TILE;
    for (int i = tid; i < O_PANELS * (BN - first) * 8; i += WG) {
      const int p4 = i / ((BN - first) * 8);
      const int row = first + (i / 8) % (BN - first);
      *reinterpret_cast<uint4*>(t + (w * O_PANELS + p4) * Gm::PANEL +
                                row * 128 + (i % 8) * 16) =
          make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();
    named_sync(2 + w, WG);
  };

  // S = Q K^T of tile g (stage s) over the depth of the 9 panels, issued
  auto issue_s = [&](int s, float (&sc)[BN / 2], int g) {
    mbar_wait(full(s), (g / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da =
            smem_desc(base + p * Gm::Q_PANEL + kk * 32, 16, 1024, 1);
        s_product<BN>(sc, da, stage(s) + p * Gm::PANEL + kk * 32,
                      p > 0 || kk > 0);
      }
    }
    wgmma_commit();
  };

  // the other's tile h (stage sh): its P and statistics, O += P V from
  // them, issued
  auto issue_other_pv = [&](int sh, int h) {
    mbar_wait(pfull, h & 1);
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      alpha[j] = stats[4 * r_of[j]];
      m[j] = stats[4 * r_of[j] + 1];
      l[j] = stats[4 * r_of[j] + 2];
    }
#pragma unroll
    for (int p4 = 0; p4 < O_PANELS; ++p4) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p4][i] *= alpha[(i >> 1) & 1];
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t da = smem_desc(
          ps + (kk / 2) * Gm::P_PANEL + (kk % 2) * 32, 16, 8 * Gm::P_SWB, 2);
#pragma unroll
      for (int p4 = 0; p4 < O_PANELS; ++p4) {
        const uint64_t db = smem_desc(
            stage(sh) + (w * O_PANELS + p4) * Gm::PANEL + kk * 16 * 128,
            1024, 1024, 1);
        wgmma_ss_n64_tb(o[p4], da, db);
      }
    }
    wgmma_commit();
  };

  // One step of a consumer, at its own tile g (OWN: g < tiles) after the
  // other's tile g - 1 (OTHER: 1 <= g <= tiles). Each variant is straight
  // code from its products' issue to their wait, so that no product is in
  // flight across a branch.
  auto step = [&](int g, auto own_tag, auto other_tag) {
    constexpr bool OWN = decltype(own_tag)::value;
    constexpr bool OTHER = decltype(other_tag)::value;
    const int s = g % STAGES, h = g - 1, sh = (g + STAGES - 1) % STAGES;
    if (OTHER && h == tiles - 1) {
      // V's tail in the other's last tile (it has landed: the tile's
      // first wait is the owner's, this one sees the same phase)
      mbar_wait(full(sh), (h / STAGES) & 1);
      zero_tail(h);
    }
    float sc[BN / 2];
    if constexpr (OWN && !SERIAL) issue_s(s, sc, g);
    if constexpr (OTHER) issue_other_pv(sh, h);
    if constexpr (SERIAL && OTHER) {
      // one stage: free it before the own tile is loaded into it
      wgmma_wait_all();
#pragma unroll
      for (int p4 = 0; p4 < O_PANELS; ++p4) reg_fence(o[p4]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(sh));
    }
    if constexpr (OWN && SERIAL) issue_s(s, sc, g);
    wgmma_wait_all();
    if constexpr (OWN) reg_fence(sc);
#pragma unroll
    for (int p4 = 0; p4 < O_PANELS; ++p4) reg_fence(o[p4]);
    if constexpr (OTHER && !SERIAL) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(sh));
    }
    if constexpr (OWN) {
      // the online softmax of this consumer's tile, on the registers
      const int k0 = klo + g * BN;
      const float* ksc =
          reinterpret_cast<const float*>(gbase + Gm::SC_OFF) + s * BN;
      float alpha[2];
      if (k0 + BN - 1 > q_min) {
        softmax_tile<BN, true, QUANT>(sc, m, l, alpha, a.scale, k0, lane,
                                      qlim, ksc);
      } else {
        softmax_tile<BN, false, QUANT>(sc, m, l, alpha, a.scale, k0, lane,
                                       qlim, ksc);
      }
      // P in bf16: wgmma's A fragments, 16 keys each (the accumulator
      // layout of two 8-key groups is the A layout of one 16-key step), and
      // the same values into the shared P (panels of 32 keys), with the
      // rows' statistics, for the other consumer
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pa[kk][q] = pack_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
          // row (q & 1) of the pair, keys 16 kk + 8 (q >> 1) + 2 (lane & 3)
          // and the next
          const int col = 16 * kk + 8 * (q >> 1) + 2 * (lane & 3);
          *reinterpret_cast<uint32_t*>(
              pg + (col / 32) * Gm::P_PANEL +
              swz<Gm::P_SWB>(r_of[q & 1] * Gm::P_SWB + (col % 32) * 2)) =
              pa[kk][q];
        }
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          stats[4 * r_of[j]] = alpha[j];
          stats[4 * r_of[j] + 1] = m[j];
          stats[4 * r_of[j] + 2] = l[j];
        }
      }
      fence_async_smem();  // P is read by the other's wgmma (async proxy)
      __syncwarp();
      if (lane == 0) mbar_arrive(pfull);

      // O += P V on this consumer's half, P from the registers
      if (g == tiles - 1) zero_tail(g);
#pragma unroll
      for (int p4 = 0; p4 < O_PANELS; ++p4) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[p4][i] *= alpha[(i >> 1) & 1];
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int p4 = 0; p4 < O_PANELS; ++p4) {
          const uint64_t db = smem_desc(
              stage(s) + (w * O_PANELS + p4) * Gm::PANEL + kk * 16 * 128,
              1024, 1024, 1);
          wgmma_rs_n64(o[p4], pa[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int p4 = 0; p4 < O_PANELS; ++p4) reg_fence(o[p4]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
  };
  using yes = std::true_type;
  using no = std::false_type;
  // consumer 0 opens with tile 0 alone; then both take a tile of their own
  // after the other's; the last tile's other consumer closes with it alone
  int g = w;
  if (w == 0 && tiles > 0) {
    step(0, yes(), no());
    g = 2;
  }
  for (; g < tiles; g += 2) step(g, yes(), yes());
  if (g == tiles && tiles > 0) step(g, no(), yes());

  // this consumer's columns: normalized in bf16 (with no live key l = 0
  // and the row gives 0), or a split's unnormalized partial in fp32 with
  // (m, l), m in the natural-log domain
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = f0 + r_of[j];
    if (f >= R) continue;
    if (split) {
      float* dst = a.part_o + (part0 + f) * a.r;
#pragma unroll
      for (int p4 = 0; p4 < O_PANELS; ++p4) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = (w * O_PANELS + p4) * 64 + c * 8 + 2 * (lane & 3);
          if (col >= a.r) continue;
          const int i = 4 * c + 2 * j;
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(o[p4][i], o[p4][i + 1]);
        }
      }
      if (w == 0 && (lane & 3) == 0) {
        a.part_ml[2 * (part0 + f)] = l[j] > 0.f ? m[j] * LN2 : NEG_INF;
        a.part_ml[2 * (part0 + f) + 1] = l[j];
      }
      continue;
    }
    const float inv = l[j] > 0.f ? 1.f / l[j] : 0.f;
    bf16* dst = static_cast<bf16*>(a.out) + b * a.ob + (f / a.H) * a.ot +
                static_cast<long long>(f % a.H) * a.oh;
#pragma unroll
    for (int p4 = 0; p4 < O_PANELS; ++p4) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = (w * O_PANELS + p4) * 64 + c * 8 + 2 * (lane & 3);
        if (col >= a.r) continue;
        const int i = 4 * c + 2 * j;
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(o[p4][i] * inv, o[p4][i + 1] * inv);
      }
    }
  }
}

// ------------------------------------------------------------ host ---

// The latent rows as a 3-d tensor map, C columns innermost: dense [B, S, C]
// in boxes of 64 columns by BN keys at (key, sequence); paged [P, page, C]
// in boxes of 64 columns by `box` rows at (row in page, page id). bf16: the
// 128-byte swizzle of the panels; int8: unswizzled, for the staging ring.
// Columns past C, keys past S and pages outside the pool read as zeros.
template <typename KV, bool PAGED, int BN>
bool encode_latent_map(CUtensorMap* map, const LatentArgs& a, int B) {
  using Gm = Geometry<KV, BN>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr || a.ks < 0 || a.kb < 0) return false;
  const int rows = PAGED ? a.page : (a.S > 1 ? a.S : 1);
  const int outer = PAGED ? a.P : (B > 1 ? B : 1);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.C),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(a.ks) * sizeof(KV),
      static_cast<cuuint64_t>(a.kb) * sizeof(KV)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(PAGED ? a.box : BN),
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                Gm::QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(a.kv), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Gm::QUANT ? CU_TENSOR_MAP_SWIZZLE_NONE
                          : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Check the sizes, encode the map and launch on `stream` over a grid of
// (row blocks, nsplit, B). Returns a cudaError_t.
template <typename KV, bool PAGED, int BN>
int launch(const LatentArgs* a, int B, int nsplit, void* stream) {
  using Gm = Geometry<KV, BN>;
  if constexpr (!Gm::FITS) {
    return cudaErrorInvalidValue;
  } else {
    static_assert(Gm::BYTES <= SMEM_LIMIT, "the body does not fit");
    if (a == nullptr || B < 0 || a->T < 0 || a->H <= 0 || a->C <= 0 ||
        a->C % 16 != 0 || a->C > MAX_C || a->r <= 0 || a->r % 16 != 0 ||
        a->r > a->C || a->r > MAX_R || a->S < 0) {
      return cudaErrorInvalidValue;
    }
    if (Gm::QUANT && a->kv_scale == nullptr) return cudaErrorInvalidValue;
    if (PAGED && (a->page_table == nullptr || a->NP <= 0 || a->P <= 0 ||
                  a->page <= 0 || a->S != a->NP * a->page || a->box <= 0 ||
                  BN % a->box != 0 || a->page % a->box != 0)) {
      return cudaErrorInvalidValue;
    }
    if (a->split > 0
            ? (a->split % BN != 0 || a->part_o == nullptr ||
               a->part_ml == nullptr ||
               nsplit != (a->S + a->split - 1) / a->split + (a->S == 0))
            : nsplit != 1) {
      return cudaErrorInvalidValue;
    }
    if (B == 0 || a->T == 0) return cudaSuccess;
    static std::atomic<int> raised[64];
    cudaError_t err =
        raise_smem_limit(latent_sm90_fwd<KV, PAGED, BN>, Gm::BYTES, raised);
    if (err != cudaSuccess) return err;
    CUtensorMap map;
    if (!encode_latent_map<KV, PAGED, BN>(&map, *a, B)) {
      return cudaErrorInvalidValue;
    }
    const dim3 grid((a->H * a->T + BM - 1) / BM, nsplit, B);
    latent_sm90_fwd<KV, PAGED, BN><<<grid, THREADS, Gm::BYTES,
                                     static_cast<cudaStream_t>(stream)>>>(
        *a, map);
    return cudaGetLastError();
  }
}

}  // namespace latent
}  // namespace lmc
