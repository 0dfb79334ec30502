// The prefill ablation variants of row 1's attention body, for Hopper
// (sm_90a).
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
//   pipelined full's function: step j issues tile j's QK product into one
//             of two score buffers, then runs tile j - 1's softmax and PV
//             from the other (V lags K by one tile), and a drain step
//             flushes the last tile.
//
// The physical tiles are row 1's (flash_common.cuh): a block of BM = 64
// (token, head-in-group) rows of one KV head, flattened token-major (the
// group size divides 64, so a block lies in one logical query block), key
// tiles of BN = 64, 4 warps, WMMA bf16 16x16x16 with fp32 accumulation, the
// scores and the output accumulator in shared memory. The logical blocks
// only decide which 64-key tiles are visited and what is masked; the TPU's
// 256 x 1024 VMEM blocks are not copied.
//
// Bound on an H100: the tool's shape (S 8192, H 32, D 128) does
// 0.5 * S^2 * H * D * 4 = 550 GFLOP causally (more for the unmasked modes,
// which take every live block whole) on 168 MB, far above the card's ~295
// FLOP/byte ridge, so every variant is bound by its tensor-core operations.
// This is a simple kernel: the products go through shared memory, and
// wgmma / TMA are left to a later revision.

#include "flash_common.cuh"

namespace lmc {

enum VariantMode { FULL = 0, NO_MASK = 1, MXU_ONLY = 2 };

// Shared memory of a variant: row 1's layout with STAGES K/V tile pairs
// (two for pair, one otherwise), then a second score buffer where the
// variant keeps two (pair, pipelined).
template <int D, int STAGES, bool TWO_SCORES>
struct VariantSmem {
  using L = FlashSmem<D>;
  static constexpr int S2_OFF = L::KV_OFF + STAGES * 2 * L::TILE;
  static constexpr int BYTES = S2_OFF + (TWO_SCORES ? BM * L::LDS * 4 : 0);
};

// One K or V tile: keys [k0, k0 + BN) of `base` (row stride `stride`),
// zero at and past kend.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long stride, int k0,
                                          int kend) {
  constexpr int LDQ = FlashSmem<D>::LDQ;
  for (int i = threadIdx.x; i < BN * (D / 8); i += THREADS) {
    const int row = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (k0 + row < kend) {
      val = *reinterpret_cast<const uint4*>(base + (k0 + row) * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + row * LDQ + c) = val;
  }
}

// Online-softmax update of one row over the tile at k0 (flash_softmax
// without int8 scales and softcap); MASK: the causal mask and kv_len, else
// every key of the tile counts.
template <int D, bool MASK>
__device__ __forceinline__ void variant_softmax(const float* Ss, bf16* Ps,
                                                float* Os, const FlashArgs& a,
                                                FlashRow& w, int k0) {
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
    const float s = srow[2 * i] * a.scale;
    sv[i] = (!MASK || kfirst + 2 * i <= w.qlim) ? s : NEG_INF;
    mx = fmaxf(mx, sv[i]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(w.m, mx);
  const float alpha = expf(w.m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const float p = sv[i] > 0.5f * NEG_INF ? expf(sv[i] - m_new) : 0.f;
    sum += p;
    prow[2 * i] = __float2bfloat16(p);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  w.l = alpha * w.l + sum;
  w.m = m_new;
  for (int d = w.half; d < D; d += 2) orow[d] *= alpha;
  __syncwarp();
}

// mxu_only: P = bf16(scale * S), no max, no exponent, O not rescaled.
template <int D>
__device__ __forceinline__ void variant_scaled_scores(const float* Ss,
                                                      bf16* Ps,
                                                      const FlashArgs& a,
                                                      const FlashRow& w) {
  using L = FlashSmem<D>;
  const float* srow = Ss + w.row * L::LDS + w.half;
  bf16* prow = Ps + w.row * L::LDP + w.half;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    prow[2 * i] = __float2bfloat16(srow[2 * i] * a.scale);
  }
  __syncwarp();
}

// One tile's update after its scores are in Ss: the mode's P, then O += PV.
template <int D, int MODE>
__device__ __forceinline__ void variant_update(const float* Ss, bf16* Ps,
                                               const bf16* Vs, float* Os,
                                               const FlashArgs& a,
                                               FlashRow& w, int k0) {
  if (MODE == MXU_ONLY) {
    variant_scaled_scores<D>(Ss, Ps, a, w);
  } else {
    variant_softmax<D, MODE == FULL>(Ss, Ps, Os, a, w, k0);
  }
  flash_pv<D>(Ps, Vs, Os);
}

// What the logical blocks leave a block of rows: the end of its key walk
// and the number of live key blocks (mxu_only's divisor).
struct VariantRange {
  int kend, nlive;
};

__device__ __forceinline__ VariantRange variant_range(const FlashArgs& a,
                                                      const FlashBlock& r,
                                                      int mode, int bq,
                                                      int bk, int nkb) {
  const int iq = (r.f0 / a.G) / bq;
  const int qpos_max = r.qoff + (iq + 1) * bq - 1;
  VariantRange v;
  v.nlive = max(0, min(qpos_max / bk + 1, nkb));
  // unmasked modes take every key of the live blocks (the wrapper makes
  // S a multiple of bk for them); full stops at the causal limit
  v.kend = mode == FULL ? min(r.kend, v.nlive * bk) : min(v.nlive * bk, a.S);
  return v;
}

// The variant kernels: one key tile a step, or two (PAIR).
template <int D, int MODE, bool PAIR>
__global__ void __launch_bounds__(THREADS)
    variant_fwd(const FlashArgs a, int bq, int bk, int nkb) {
  using L = FlashSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  float* S0 = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  bf16* K0 = reinterpret_cast<bf16*>(smem + L::KV_OFF);
  bf16* V0 = K0 + L::TILE / 2;
  bf16* K1 = V0 + L::TILE / 2;  // PAIR only
  bf16* V1 = K1 + L::TILE / 2;
  float* S1 = reinterpret_cast<float*>(
      smem + VariantSmem<D, 2, true>::S2_OFF);  // PAIR only

  const FlashBlock r = flash_block(a);
  FlashRow w = flash_row(a, r);
  const VariantRange vr = variant_range(a, r, MODE, bq, bk, nkb);
  const bf16* kbase = static_cast<const bf16*>(a.k) + r.bkv * a.kb +
                      blockIdx.y * a.kh;
  const bf16* vbase = static_cast<const bf16*>(a.v) + r.bkv * a.vb +
                      blockIdx.y * a.vh;
  const bool warp_live = r.f0 + (threadIdx.x / 32) * 16 < r.rows;

  flash_load_q<D>(Qs, a, r);
  float* orow = Os + w.row * L::LDO;
  for (int d = w.half; d < D; d += 2) orow[d] = 0.f;

  for (int k0 = 0; k0 < vr.kend; k0 += PAIR ? 2 * BN : BN) {
    const bool two = PAIR && k0 + BN < vr.kend;
    __syncthreads();  // the previous tiles are no longer read
    flash_load_tiles<D, bf16, false>(K0, V0, kbase, vbase, a.ks, a.vs, k0,
                                     vr.kend);
    if (two) {
      flash_load_tiles<D, bf16, false>(K1, V1, kbase, vbase, a.ks, a.vs,
                                       k0 + BN, vr.kend);
    }
    __syncthreads();
    if (!warp_live) continue;  // warp-uniform; block barriers stay matched
    flash_scores<D>(Qs, K0, S0);
    if (two) flash_scores<D>(Qs, K1, S1);  // both products first
    variant_update<D, MODE>(S0, Ps, V0, Os, a, w, k0);
    if (two) variant_update<D, MODE>(S1, Ps, V1, Os, a, w, k0 + BN);
  }
  if (MODE == MXU_ONLY) {
    w.m = 0.f;
    w.l = static_cast<float>(vr.nlive);  // out = acc / live blocks
  }
  flash_write<D>(Os, a, r, w);
}

// full's function as a software pipeline over the key tiles.
template <int D>
__global__ void __launch_bounds__(THREADS)
    pipelined_fwd(const FlashArgs a, int bq, int bk, int nkb) {
  using L = FlashSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  float* Sbuf[2] = {
      reinterpret_cast<float*>(smem + L::S_OFF),
      reinterpret_cast<float*>(smem + VariantSmem<D, 1, true>::S2_OFF)};
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::KV_OFF);
  bf16* Vs = Ks + L::TILE / 2;

  const FlashBlock r = flash_block(a);
  FlashRow w = flash_row(a, r);
  const VariantRange vr = variant_range(a, r, FULL, bq, bk, nkb);
  const bf16* kbase = static_cast<const bf16*>(a.k) + r.bkv * a.kb +
                      blockIdx.y * a.kh;
  const bf16* vbase = static_cast<const bf16*>(a.v) + r.bkv * a.vb +
                      blockIdx.y * a.vh;
  const bool warp_live = r.f0 + (threadIdx.x / 32) * 16 < r.rows;

  flash_load_q<D>(Qs, a, r);
  float* orow = Os + w.row * L::LDO;
  for (int d = w.half; d < D; d += 2) orow[d] = 0.f;

  const int ntiles = (vr.kend + BN - 1) / BN;
  for (int j = 0; j <= ntiles; ++j) {  // j == ntiles: the drain step
    __syncthreads();
    if (j < ntiles) load_tile<D>(Ks, kbase, a.ks, j * BN, vr.kend);
    if (j > 0) load_tile<D>(Vs, vbase, a.vs, (j - 1) * BN, vr.kend);
    __syncthreads();
    if (!warp_live) continue;
    if (j < ntiles) flash_scores<D>(Qs, Ks, Sbuf[j & 1]);  // into the stash
    if (j > 0) {
      variant_update<D, FULL>(Sbuf[(j - 1) & 1], Ps, Vs, Os, a, w,
                              (j - 1) * BN);
    }
  }
  flash_write<D>(Os, a, r, w);
}

template <typename Kernel>
cudaError_t variant_launch(Kernel kernel, int bytes, std::atomic<int>* raised,
                           const FlashArgs& a, int B, int Hkv, int bq, int bk,
                           int nkb, cudaStream_t stream) {
  cudaError_t err = raise_smem_limit(kernel, bytes, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T * a.G + BM - 1) / BM, Hkv, B);
  kernel<<<grid, THREADS, bytes, stream>>>(a, bq, bk, nkb);
  return cudaGetLastError();
}

template <int D, int MODE, bool PAIR>
cudaError_t launch_variant(const FlashArgs& a, int B, int Hkv, int bq, int bk,
                           int nkb, cudaStream_t s) {
  constexpr int bytes = VariantSmem<D, PAIR ? 2 : 1, PAIR>::BYTES;
  static_assert(bytes <= SMEM_LIMIT, "tiles do not fit shared memory");
  static std::atomic<int> raised[64];
  return variant_launch(variant_fwd<D, MODE, PAIR>, bytes, raised, a, B, Hkv,
                        bq, bk, nkb, s);
}

template <int D>
cudaError_t launch_pipelined(const FlashArgs& a, int B, int Hkv, int bq,
                             int bk, int nkb, cudaStream_t s) {
  constexpr int bytes = VariantSmem<D, 1, true>::BYTES;
  static_assert(bytes <= SMEM_LIMIT, "tiles do not fit shared memory");
  static std::atomic<int> raised[64];
  return variant_launch(pipelined_fwd<D>, bytes, raised, a, B, Hkv, bq, bk,
                        nkb, s);
}

template <int D>
cudaError_t variant_dispatch(const FlashArgs& a, int B, int Hkv, int mode,
                             int pair, int pipelined, int bq, int bk, int nkb,
                             cudaStream_t s) {
  if (pipelined) return launch_pipelined<D>(a, B, Hkv, bq, bk, nkb, s);
  switch (mode * 2 + (pair ? 1 : 0)) {
    case FULL * 2:
      return launch_variant<D, FULL, false>(a, B, Hkv, bq, bk, nkb, s);
    case FULL * 2 + 1:
      return launch_variant<D, FULL, true>(a, B, Hkv, bq, bk, nkb, s);
    case NO_MASK * 2:
      return launch_variant<D, NO_MASK, false>(a, B, Hkv, bq, bk, nkb, s);
    case NO_MASK * 2 + 1:
      return launch_variant<D, NO_MASK, true>(a, B, Hkv, bq, bk, nkb, s);
    case MXU_ONLY * 2:
      return launch_variant<D, MXU_ONLY, false>(a, B, Hkv, bq, bk, nkb, s);
    case MXU_ONLY * 2 + 1:
      return launch_variant<D, MXU_ONLY, true>(a, B, Hkv, bq, bk, nkb, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace lmc

// Plain C entry point, bound with ctypes: row 1's argument block (q and out
// strides of the head-major [B, H, Tp, D] tensors as [B, Tp, H, D] views),
// the sizes it does not hold, the variant (mode 0 full, 1 no_mask,
// 2 mxu_only; pair; pipelined), the logical blocks bq and bk, the number of
// key blocks visited, the stream; returns a cudaError_t (0 on success).
extern "C" int lmc_prefill_variant(const lmc::FlashArgs* a, int B, int H,
                                   int Hkv, int D, int mode, int pair,
                                   int pipelined, int bq, int bk, int nkb,
                                   void* stream) {
  if (lmc::flash_bad_sizes(a, B, H, Hkv) || mode < 0 || mode > 2 ||
      bq <= 0 || bk <= 0 || bq % lmc::BM != 0 || bk % lmc::BN != 0 ||
      lmc::BM % a->G != 0 || a->T % bq != 0 || nkb < 0 ||
      (pipelined && (mode != lmc::FULL || pair))) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return lmc::variant_dispatch<64>(*a, B, Hkv, mode, pair, pipelined, bq,
                                       bk, nkb, s);
    case 128:
      return lmc::variant_dispatch<128>(*a, B, Hkv, mode, pair, pipelined,
                                        bq, bk, nkb, s);
    default:
      return cudaErrorInvalidValue;
  }
}
