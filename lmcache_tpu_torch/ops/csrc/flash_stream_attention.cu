// Windowless causal flash attention that streams K/V through a deep ring of
// TMA stages, for Hopper (sm_90a): the prefill-oriented variant of
// flash_attention.cu.
//
// Replaces the TPU kernel lmcache_tpu/ops/attention.py::_flash_dma_kernel
// (entry point flash_attention_dma). Same contract and results as
// flash_attention.cu without window, softcap, sinks and kv_slot, which the
// entry point refuses, as it refuses D = 256.
//
// On the TPU the two kernels differ in how K/V reach VMEM: _flash_kernel by
// the pipeline's synchronous block copies, _flash_dma_kernel by its own
// 4-deep ring of asynchronous DMAs with semaphores, so that the next blocks
// are in flight while the current one is computed. On Hopper both are one
// design, the body of flash_sm90.cuh: a producer warp keeps TMA loads in
// flight through a ring of stages with mbarriers while the consumer
// warpgroups run wgmma on the tiles that have arrived. What stays of the
// DMA kernel is the depth of its ring: this entry point instantiates the
// body without options at the deepest ring that shared memory allows
// (6 stages of 128 keys at D = 64, 4 at D = 96, 3 at D = 128), where
// flash_attention.cu keeps 2. The tiles and the order of every sum are the
// same, so the two give the same bits on the same inputs.
//
// Bound on an H100: as flash_attention.cu's prefill, by the tensor-core
// operations.

#include "flash_sm90.cuh"

namespace {

using lmc::FlashArgs;

template <int D>
cudaError_t launch(const FlashArgs& a, int B, int Hkv, cudaStream_t stream) {
  constexpr int stages = lmc::sm90::Geometry<D>::max_stages();
  return lmc::sm90::launch<D, stages, false>(a, B, Hkv, stream);
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
