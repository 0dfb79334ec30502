// The WMMA body of the int8 dense kernel (quantized_flash_attention.cu) and
// of the prefill ablation variants (prefill_variants.cu): the shared-memory
// layout, the block's key range under the causal limit and the window, the
// tile loaders for bf16 and int8 K/V, the score product, the online-softmax
// update with every option (per-key scales, softcap, sliding and chunked
// windows), the PV product and the final normalization with attention
// sinks. The contract and the argument block are flash_args.cuh's; the bf16
// kernels of rows 1 and 2 run the Hopper body of flash_sm90.cuh instead.
//
// Layout of one block: BM = 64 query rows = consecutive (token,
// head-in-group) pairs of one (batch, KV head), flattened token-major, so any
// group size works and one block spans 64 / G tokens. Four warps own 16 rows
// each; warps with no live row (decode with a small group) only help load.
// Per tile of BN = 64 keys: S = Q K^T (WMMA bf16 16x16x16, fp32 accumulate,
// to shared memory) -> two lanes per row run the online softmax and write P
// in bf16 -> O (fp32, shared memory) is rescaled by alpha and O += P V.

#pragma once

#include "flash_args.cuh"

namespace lmc {

constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per K/V tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// Shared memory in bytes. Row pitches are padded (multiples of 8 bf16 / 4
// fp32 as WMMA requires) to spread the rows over the banks; every array and
// every 16-row fragment starts on a 32-byte boundary. `STAGES` K/V tile pairs
// follow the fixed part.
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
  static constexpr int SC_OFF = O_OFF + BM * LDO * 4;  // k, v scales [2][BN]
  static constexpr int KV_OFF = SC_OFF + 2 * BN * 4;
  static constexpr int TILE = BN * LDQ * 2;  // one K or V tile
  static constexpr int bytes(int stages) { return KV_OFF + stages * 2 * TILE; }
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
// start together; int8 rows convert exactly to bf16.
template <int D, typename KV>
__device__ __forceinline__ void flash_load_tiles(bf16* Ks, bf16* Vs,
                                                 const KV* kbase,
                                                 const KV* vbase,
                                                 long long ks, long long vs,
                                                 int k0, int kend) {
  constexpr int LDQ = FlashSmem<D>::LDQ;
  constexpr int VEC = Vec<KV>::N;
  for (int i = threadIdx.x; i < BN * (D / VEC); i += THREADS) {
    const int row = i / (D / VEC);
    const int c = (i % (D / VEC)) * VEC;
    bf16* kd = Ks + row * LDQ + c;
    bf16* vd = Vs + row * LDQ + c;
    if (k0 + row < kend) {
      const KV* ksrc = kbase + (k0 + row) * ks + c;
      const KV* vsrc = vbase + (k0 + row) * vs + c;
      const uint4 kraw = *reinterpret_cast<const uint4*>(ksrc);
      const uint4 vraw = *reinterpret_cast<const uint4*>(vsrc);
      store_converted(kd, kraw, KV());
      store_converted(vd, vraw, KV());
    } else {
      store_zero<VEC>(kd);
      store_zero<VEC>(vd);
    }
  }
}

// The per-key scales of a tile (int8 K/V), 0 at and past kend.
__device__ __forceinline__ void flash_load_scales(float* ksc, float* vsc,
                                                  const FlashArgs& a,
                                                  const FlashBlock& r,
                                                  int k0) {
  const float* kb = a.k_scale + r.bkv * a.ksb;
  const float* vb = a.v_scale + r.bkv * a.vsb;
  for (int c = threadIdx.x; c < BN; c += THREADS) {
    const bool live = k0 + c < r.kend;
    ksc[c] = live ? kb[(k0 + c) * a.kss] : 0.f;
    vsc[c] = live ? vb[(k0 + c) * a.vss] : 0.f;
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

// Online-softmax update of one row over the tile at k0: scale (times the
// key's K scale for int8), softcap, mask, running max and sum, P in bf16
// (times the key's V scale, after the row sum), O rescaled by alpha. The
// lane's 32 scores stay in registers between the two passes.
template <int D, bool QUANT, bool SOFTCAP>
__device__ __forceinline__ void flash_softmax(const float* Ss, bf16* Ps,
                                              float* Os, const float* ksc,
                                              const float* vsc,
                                              const FlashArgs& a, FlashRow& w,
                                              int k0) {
  using L = FlashSmem<D>;
  constexpr int NC = BN / 2;
  const float* srow = Ss + w.row * L::LDS + w.half;
  bf16* prow = Ps + w.row * L::LDP + w.half;
  float* orow = Os + w.row * L::LDO;
  const int kfirst = k0 + w.half;
  float sv[NC];
  float mx = NEG_INF;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float s = QUANT ? srow[2 * i] * (ksc[w.half + 2 * i] * a.scale)
                    : srow[2 * i] * a.scale;
    if (SOFTCAP) s = a.softcap * tanhf(s / a.softcap);
    const int kpos = kfirst + 2 * i;
    sv[i] = kpos <= w.qlim && kpos > w.wlo ? s : NEG_INF;
    mx = fmaxf(mx, sv[i]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(w.m, mx);
  const float alpha = expf(w.m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float p = sv[i] > 0.5f * NEG_INF ? expf(sv[i] - m_new) : 0.f;
    sum += p;  // the row sum comes before the V scale
    if (QUANT) p *= vsc[w.half + 2 * i];
    prow[2 * i] = __float2bfloat16(p);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  w.l = alpha * w.l + sum;
  w.m = m_new;
  for (int d = w.half; d < D; d += 2) orow[d] *= alpha;
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

// The body of quantized_flash_attention.cu (KV = int8): one
// K/V tile pair in shared memory, loaded synchronously, from the tile that
// holds the window's first key to the causal limit. SOFTCAP: the launch has a
// score softcap (a variant of its own, so that the others carry no tanh).
template <int D, typename KV, bool SOFTCAP>
__device__ __forceinline__ void flash_body(const FlashArgs& a) {
  constexpr bool QUANT = sizeof(KV) == 1;
  using L = FlashSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  float* ksc = reinterpret_cast<float*>(smem + L::SC_OFF);
  float* vsc = ksc + BN;
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::KV_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::KV_OFF + L::TILE);

  const FlashBlock r = flash_block(a);
  FlashRow w = flash_row(a, r);
  const KV* kbase = static_cast<const KV*>(a.k) + r.bkv * a.kb +
                    blockIdx.y * a.kh;
  const KV* vbase = static_cast<const KV*>(a.v) + r.bkv * a.vb +
                    blockIdx.y * a.vh;
  const bool warp_live = r.f0 + (threadIdx.x / 32) * 16 < r.rows;

  flash_load_q<D>(Qs, a, r);
  float* orow = Os + w.row * L::LDO;
  for (int d = w.half; d < D; d += 2) orow[d] = 0.f;

  for (int k0 = r.kbeg; k0 < r.kend; k0 += BN) {
    __syncthreads();  // the previous tile is no longer read
    flash_load_tiles<D, KV>(Ks, Vs, kbase, vbase, a.ks, a.vs, k0, r.kend);
    if (QUANT) flash_load_scales(ksc, vsc, a, r, k0);
    __syncthreads();
    if (!warp_live) continue;  // warp-uniform; block barriers stay matched
    flash_scores<D>(Qs, Ks, Ss);
    flash_softmax<D, QUANT, SOFTCAP>(Ss, Ps, Os, ksc, vsc, a, w, k0);
    flash_pv<D>(Ps, Vs, Os);
  }
  flash_write<D>(Os, a, r, w);
}

// flash_fwd<D, int8, .> (qflash_fwd in the sources' comments) is the kernel
// of quantized_flash_attention.cu.
template <int D, typename KV, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS) flash_fwd(const FlashArgs a) {
  flash_body<D, KV, SOFTCAP>(a);
}

template <int D, typename KV, bool SOFTCAP>
cudaError_t flash_launch(const FlashArgs& a, int B, int Hkv,
                         cudaStream_t stream) {
  constexpr int bytes = FlashSmem<D>::bytes(1);  // above the 48 KB default
  static_assert(bytes <= SMEM_LIMIT, "tile does not fit shared memory");
  static std::atomic<int> raised[64];
  cudaError_t err =
      raise_smem_limit(flash_fwd<D, KV, SOFTCAP>, bytes, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T * a.G + BM - 1) / BM, Hkv, B);
  flash_fwd<D, KV, SOFTCAP><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// What the C entry point of quantized_flash_attention.cu does: check, pick
// the variant by head dim and softcap, launch on `stream`. Returns a
// cudaError_t.
template <typename KV>
int flash_entry(const FlashArgs* a, int B, int H, int Hkv, int D,
                void* stream) {
  if (flash_bad_sizes(a, B, H, Hkv)) return cudaErrorInvalidValue;
  if (sizeof(KV) == 1 && (a->k_scale == nullptr || a->v_scale == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const bool cap = a->softcap > 0.f;
  switch (D) {
    case 64:
      return cap ? flash_launch<64, KV, true>(*a, B, Hkv, s)
                 : flash_launch<64, KV, false>(*a, B, Hkv, s);
    case 96:
      return cap ? flash_launch<96, KV, true>(*a, B, Hkv, s)
                 : flash_launch<96, KV, false>(*a, B, Hkv, s);
    case 128:
      return cap ? flash_launch<128, KV, true>(*a, B, Hkv, s)
                 : flash_launch<128, KV, false>(*a, B, Hkv, s);
    case 256:
      return cap ? flash_launch<256, KV, true>(*a, B, Hkv, s)
                 : flash_launch<256, KV, false>(*a, B, Hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace lmc
