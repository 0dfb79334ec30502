// The WMMA body of the prefill ablation variants (prefill_variants.cu, kernel
// row 13): the shared-memory layout, the block's key range under the causal
// limit and the window, the tile loader, the score product, the PV product
// and the final normalization with attention sinks. The contract and the
// argument block are flash_args.cuh's; the dense kernels of rows 1-3 run
// the Hopper body of flash_sm90.cuh instead.
//
// Layout of one block: BM = 64 query rows = consecutive (token,
// head-in-group) pairs of one (batch, KV head), flattened token-major, so any
// group size works and one block spans 64 / G tokens. Four warps own 16 rows
// each; warps with no live row (decode with a small group) only help load.
// Per tile of BN = 64 keys: S = Q K^T (WMMA bf16 16x16x16, fp32 accumulate,
// to shared memory) -> two lanes per row run the online softmax and write P
// in bf16 -> O (fp32, shared memory) is rescaled by alpha and O += P V.

#pragma once

#include <mma.h>

#include "flash_args.cuh"

namespace lmc {

constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per K/V tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// Shared memory in bytes. Row pitches are padded (multiples of 8 bf16 / 4
// fp32 as WMMA requires) to spread the rows over the banks; every array and
// every 16-row fragment starts on a 32-byte boundary. K/V tile pairs follow
// the fixed part.
template <int D>
struct FlashSmem {
  static constexpr int LDQ = D + 8;   // bf16 Q, K and V tiles
  static constexpr int LDS = BN + 4;  // fp32 scores
  static constexpr int LDP = BN + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // fp32 output accumulator
  static constexpr int Q_OFF = 0;
  static constexpr int S_OFF = Q_OFF + BM * LDQ * 2;
  static constexpr int P_OFF = S_OFF + BM * LDS * 4;
  static constexpr int O_OFF = P_OFF + BM * LDP * 2;
  static constexpr int KV_OFF = O_OFF + BM * LDO * 4;
  static constexpr int TILE = BN * LDQ * 2;  // one K or V tile
};

// What a block works on: its rows, its sequence's limits and the keys
// [kbeg, kend) that some row of it can see (kbeg rounded down to a tile).
struct FlashBlock {
  int f0, rows, qoff, klen, kbeg, kend;
  long long bkv;  // K/V (and scale) row of the pool
};

__device__ __forceinline__ FlashBlock flash_block(const FlashArgs& a) {
  FlashBlock r;
  const int b = blockIdx.z;
  // the last rows have the most keys: schedule them first
  r.f0 = (gridDim.x - 1 - blockIdx.x) * BM;
  r.rows = a.T * a.G;
  r.qoff = a.q_offset[b];
  r.klen = min(a.kv_len[b], a.S);
  r.bkv = a.kv_slot != nullptr ? a.kv_slot[0] : b;
  const int t_first = r.f0 / a.G;
  const int t_last = min((r.f0 + BM - 1) / a.G, a.T - 1);
  r.kend = max(0, min(r.qoff + t_last + 1, r.klen));
  // the oldest key that the block's first token sees
  r.kbeg = window_start(a, r.qoff + t_first) / BN * BN;
  return r;
}

// The row a lane works on in the softmax: lane pair (2i, 2i+1) owns row
// warp * 16 + i, each lane the interleaved columns half, half + 2, ...
struct FlashRow {
  int row, half, f;
  int qlim;  // last key under the causal limit and kv_len; -1: none
  int wlo;   // window: keys must be > wlo
  float m, l;
};

__device__ __forceinline__ FlashRow flash_row(const FlashArgs& a,
                                              const FlashBlock& r) {
  FlashRow w;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  w.row = warp * 16 + lane / 2;
  w.half = lane & 1;
  w.f = r.f0 + w.row;
  const int qpos = r.qoff + w.f / a.G;
  w.qlim = w.f < r.rows ? min(qpos, r.klen - 1) : -1;
  w.wlo = window_floor(a, qpos);
  w.m = NEG_INF;
  w.l = 0.f;
  return w;
}

// Q rows of the block into shared memory (zero past the last row).
template <int D>
__device__ __forceinline__ void flash_load_q(bf16* Qs, const FlashArgs& a,
                                             const FlashBlock& r) {
  constexpr int LDQ = FlashSmem<D>::LDQ;
  const bf16* qbase = static_cast<const bf16*>(a.q) + blockIdx.z * a.qb +
                      (long long)blockIdx.y * a.G * a.qh;
  for (int i = threadIdx.x; i < BM * D / 8; i += THREADS) {
    const int row = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int f = r.f0 + row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (f < r.rows) {
      val = *reinterpret_cast<const uint4*>(qbase + (f / a.G) * a.qt +
                                            (f % a.G) * a.qh + c);
    }
    *reinterpret_cast<uint4*>(Qs + row * LDQ + c) = val;
  }
}

// One K and one V tile: keys [k0, k0 + BN) of the two bases (row strides
// ks, vs) into bf16 tiles, zero at and past kend. K and V loads of a thread
// start together.
template <int D>
__device__ __forceinline__ void flash_load_tiles(bf16* Ks, bf16* Vs,
                                                 const bf16* kbase,
                                                 const bf16* vbase,
                                                 long long ks, long long vs,
                                                 int k0, int kend) {
  constexpr int LDQ = FlashSmem<D>::LDQ;
  for (int i = threadIdx.x; i < BN * (D / 8); i += THREADS) {
    const int row = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 kval = make_uint4(0, 0, 0, 0), vval = kval;
    if (k0 + row < kend) {
      kval = *reinterpret_cast<const uint4*>(kbase + (k0 + row) * ks + c);
      vval = *reinterpret_cast<const uint4*>(vbase + (k0 + row) * vs + c);
    }
    *reinterpret_cast<uint4*>(Ks + row * LDQ + c) = kval;
    *reinterpret_cast<uint4*>(Vs + row * LDQ + c) = vval;
  }
}

// S = Q K^T for this warp's 16 rows.
template <int D>
__device__ __forceinline__ void flash_scores(const bf16* Qs, const bf16* Ks,
                                             float* Ss) {
  using namespace nvcuda;
  using L = FlashSmem<D>;
  const int warp = threadIdx.x / 32;
  for (int j = 0; j < BN / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(qa, Qs + warp * 16 * L::LDQ + kk * 16, L::LDQ);
      wmma::load_matrix_sync(kb, Ks + j * 16 * L::LDQ + kk * 16, L::LDQ);
      wmma::mma_sync(acc, qa, kb, acc);
    }
    wmma::store_matrix_sync(Ss + warp * 16 * L::LDS + j * 16, acc, L::LDS,
                            wmma::mem_row_major);
  }
  __syncwarp();
}

// O += P V for this warp's 16 rows.
template <int D>
__device__ __forceinline__ void flash_pv(const bf16* Ps, const bf16* Vs,
                                         float* Os) {
  using namespace nvcuda;
  using L = FlashSmem<D>;
  const int warp = threadIdx.x / 32;
  for (int j = 0; j < D / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* otile = Os + warp * 16 * L::LDO + j * 16;
    wmma::load_matrix_sync(acc, otile, L::LDO, wmma::mem_row_major);
    for (int kk = 0; kk < BN / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
      wmma::load_matrix_sync(pa, Ps + warp * 16 * L::LDP + kk * 16, L::LDP);
      wmma::load_matrix_sync(vb, Vs + kk * 16 * L::LDQ + j * 16, L::LDQ);
      wmma::mma_sync(acc, pa, vb, acc);
    }
    wmma::store_matrix_sync(otile, acc, L::LDO, wmma::mem_row_major);
  }
  __syncwarp();
}

// Normalize and write the row. A sink logit joins the normalization and is
// then dropped: a correction of (m, l) at the end of the row. With no live
// key m = -1e30 and l = 0, so the row gives 0 either way.
template <int D>
__device__ __forceinline__ void flash_write(const float* Os,
                                            const FlashArgs& a,
                                            const FlashBlock& r,
                                            const FlashRow& w) {
  __syncwarp();  // with no live tile, the partner lane zeroed half the row
  if (w.f >= r.rows) return;
  const int head = blockIdx.y * a.G + w.f % a.G;
  float inv = w.l > 0.f ? 1.f / w.l : 0.f;
  if (a.sinks != nullptr) {
    const float snk = a.sinks[head];
    const float m2 = fmaxf(w.m, snk);
    const float keep = expf(w.m - m2);
    inv = keep / (w.l * keep + expf(snk - m2));
  }
  const float* orow = Os + w.row * FlashSmem<D>::LDO;
  bf16* dst = static_cast<bf16*>(a.out) + blockIdx.z * a.ob +
              (w.f / a.G) * a.ot + (long long)head * a.oh;
  for (int d = 2 * w.half; d < D; d += 4) {
    *reinterpret_cast<__nv_bfloat162*>(dst + d) =
        __floats2bfloat162_rn(orow[d] * inv, orow[d + 1] * inv);
  }
}

}  // namespace lmc
