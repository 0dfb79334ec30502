// Windowless causal flash attention that streams K/V through a ring of
// cp.async stages, for Hopper (sm_90a): the prefill-oriented variant of
// flash_attention.cu.
//
// Replaces the TPU kernel lmcache_tpu/ops/attention.py::_flash_dma_kernel
// (entry point flash_attention_dma). What carries over is not the TPU's DMA
// descriptors but the work per step: one block per (batch, KV head, q block)
// walks only the causally live tiles, with the next tiles' K and V already
// in flight while the online softmax runs on the current one. Same contract
// and results as flash_attention.cu without window, softcap, sinks and
// kv_slot; the steps of the body are the shared ones of flash_common.cuh.
//
// Bound on an H100: as flash_attention.cu (prefill by the tensor-core
// operations). flash_attention.cu stalls every tile on a synchronous
// global -> register -> shared copy between two barriers; here a tile is
// requested STAGES - 1 tiles ahead by cp.async (16 bytes a thread, L2 only,
// no registers), so the copy of tile g + 2 overlaps the products of tile g.
// The ring costs shared memory, and with it blocks per SM, which hide more
// latency than the ring does. The TPU kernel's ring is 4 deep; here 3 stages
// keep two blocks an SM at D = 64 (109056 bytes), where 4 leave one (127488):
// on an H100 (700 W) the 16k tinyllama prefill took 19.0 ms at depth 3 and
// 30.9 ms at depth 4, beside 17.8 ms for flash_attention. At D = 96 and 128
// every depth leaves one block an SM; D = 256 does not fit at all (the entry
// point refuses it). wgmma, TMA and a producer warp are left to a later
// revision.

#include "flash_common.cuh"

namespace {

using lmc::bf16;
using lmc::BN;
using lmc::FlashArgs;

constexpr int STAGES = 3;

template <int D>
__global__ void __launch_bounds__(lmc::THREADS)
flash_stream_fwd(const FlashArgs a) {
  using L = lmc::FlashSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  auto k_stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::KV_OFF + s * 2 * L::TILE);
  };
  auto v_stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::KV_OFF + s * 2 * L::TILE +
                                   L::TILE);
  };

  const lmc::FlashBlock r = lmc::flash_block(a);
  lmc::FlashRow w = lmc::flash_row(a, r);
  const bf16* kbase = static_cast<const bf16*>(a.k) + r.bkv * a.kb +
                      blockIdx.y * a.kh;
  const bf16* vbase = static_cast<const bf16*>(a.v) + r.bkv * a.vb +
                      blockIdx.y * a.vh;
  const bool warp_live = r.f0 + (threadIdx.x / 32) * 16 < r.rows;
  const int tiles = (r.kend - r.kbeg + BN - 1) / BN;  // causally live

  // request tile g into its stage; an empty group keeps the count of
  // committed groups in step with the tiles
  auto request = [&](int g) {
    if (g < tiles) {
      const int k0 = r.kbeg + g * BN;
      lmc::flash_load_tiles<D, bf16, true>(k_stage(g % STAGES),
                                           v_stage(g % STAGES), kbase, vbase,
                                           a.ks, a.vs, k0, r.kend);
    }
    lmc::async_commit();
  };

  for (int g = 0; g < STAGES - 1; ++g) request(g);
  lmc::flash_load_q<D>(Qs, a, r);
  float* orow = Os + w.row * L::LDO;
  for (int d = w.half; d < D; d += 2) orow[d] = 0.f;

  for (int g = 0; g < tiles; ++g) {
    // every warp is done with tile g - 1, whose stage tile g + STAGES - 1
    // takes
    __syncthreads();
    request(g + STAGES - 1);
    lmc::async_wait<STAGES - 1>();  // this thread's part of tile g is in
    __syncthreads();                // and so is everyone's
    if (!warp_live) continue;  // warp-uniform; block barriers stay matched
    const int k0 = r.kbeg + g * BN;
    lmc::flash_scores<D>(Qs, k_stage(g % STAGES), Ss);
    lmc::flash_softmax<D, false, false>(Ss, Ps, Os, nullptr, nullptr, a, w,
                                        k0);
    lmc::flash_pv<D>(Ps, v_stage(g % STAGES), Os);
  }
  lmc::async_wait<0>();
  lmc::flash_write<D>(Os, a, r, w);
}

template <int D>
cudaError_t launch(const FlashArgs& a, int B, int Hkv, cudaStream_t stream) {
  constexpr int bytes = lmc::FlashSmem<D>::bytes(STAGES);
  static_assert(bytes <= lmc::SMEM_LIMIT, "ring does not fit shared memory");
  static std::atomic<int> raised[64];
  cudaError_t err = lmc::raise_smem_limit(flash_stream_fwd<D>, bytes, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T * a.G + lmc::BM - 1) / lmc::BM, Hkv, B);
  flash_stream_fwd<D><<<grid, lmc::THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes, as lmc_flash_attention_bf16; the
// options of the argument block must be off.
extern "C" int lmc_flash_stream_attention_bf16(const FlashArgs* a, int B,
                                               int H, int Hkv, int D,
                                               void* stream) {
  if (lmc::flash_bad_sizes(a, B, H, Hkv)) return cudaErrorInvalidValue;
  if (a->window > 0 || a->softcap > 0.f || a->sinks != nullptr ||
      a->kv_slot != nullptr) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(*a, B, Hkv, s);
    case 96:
      return launch<96>(*a, B, Hkv, s);
    case 128:
      return launch<128>(*a, B, Hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}
