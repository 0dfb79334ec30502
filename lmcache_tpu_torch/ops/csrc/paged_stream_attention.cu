// Paged attention that streams the live pages, for Hopper (sm_90a): the
// decode-oriented paged kernel, head dims 64, 128 and 256.
//
// Replaces the TPU kernels
// lmcache_tpu/ops/paged_attention.py::_paged_dma_kernel (entry point
// paged_attention_dma, row 6) and ::_paged_dma_kernel_q (entry point
// quantized_paged_attention_dma, row 7). Same contract as
// paged_attention.cu, its options (sliding or chunked window, softcap,
// sinks) included.
//
// The design of paged_attention.cu's rows 4 and 5: the Hopper body of
// flash_sm90.cuh over the arena read through the page table, and at most
// 16 rows T * G (every decode step) the paged key-split decode of
// flash_split.cuh and flash_attention.cu's combine. Row 6, bf16 arenas,
// runs the deepest ring of TMA stages that shared memory holds (6 at D 64,
// 3 at D 128, 2 at D 256; row 2's), which is what stays of the TPU kernel's
// own ring of DMAs. Row 7, int8 arenas, runs row 3's ring: 2 bf16 stages
// and a staging ring of int8 pieces as deep as the rest of shared memory
// holds (4 stages), which is its stream of DMAs; it is the same
// instantiation as row 5's. Bound on an H100: prefill by the tensor-core
// operations, decode by the live K/V bytes (~4 G operations a byte, int8
// twice that): at tinyllama's decode (B 4, H_kv 4) one block a (sequence,
// KV head) would leave 16 blocks on 132 SMs; the split puts
// B * H_kv * NP * page / 256 blocks on them.

#include "flash_sm90.cuh"
#include "flash_split.cuh"

namespace {

// The body at head dim D and the ring's depth, with the softcap a variant
// of its own (as row 1's) so that the others carry no tanh.
template <int D, typename KV>
cudaError_t stream_launch(const lmc::FlashArgs& a, int B, int Hkv,
                          cudaStream_t stream) {
  using lmc::sm90::launch;
  constexpr int stages =
      sizeof(KV) == 1 ? 2 : lmc::sm90::Geometry<D>::max_stages();
  return a.softcap > 0.f ? launch<D, stages, true, KV, true>(a, B, Hkv, stream)
                         : launch<D, stages, false, KV, true>(a, B, Hkv,
                                                              stream);
}

template <typename KV>
int body(const lmc::FlashArgs* a, int B, int H, int Hkv, int D,
         void* stream) {
  if (lmc::flash_bad_sizes(a, B, H, Hkv)) return cudaErrorInvalidValue;
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return stream_launch<64, KV>(*a, B, Hkv, s);
    case 128:
      return stream_launch<128, KV>(*a, B, Hkv, s);
    case 256:
      return stream_launch<256, KV>(*a, B, Hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes, as paged_attention.cu's.

// Rows 6 and 7's prefill body.
extern "C" int lmc_paged_stream_attention_bf16(const lmc::FlashArgs* a,
                                               int B, int H, int Hkv, int D,
                                               void* stream) {
  return body<lmc::bf16>(a, B, H, Hkv, D, stream);
}

extern "C" int lmc_paged_stream_attention_int8(const lmc::FlashArgs* a,
                                               int B, int H, int Hkv, int D,
                                               void* stream) {
  return body<lmc::i8>(a, B, H, Hkv, D, stream);
}

// Rows 6 and 7's split decode, its first kernel, as
// lmc_paged_attention_decode_split_* of paged_attention.cu.
extern "C" int lmc_paged_stream_attention_decode_split_bf16(
    const lmc::FlashArgs* a, int B, int H, int Hkv, int D, void* part_o,
    void* part_ml, int nsplit, void* stream) {
  return lmc::split::split_entry<lmc::bf16, true>(a, B, H, Hkv, D, part_o,
                                                  part_ml, nsplit, stream);
}

extern "C" int lmc_paged_stream_attention_decode_split_int8(
    const lmc::FlashArgs* a, int B, int H, int Hkv, int D, void* part_o,
    void* part_ml, int nsplit, void* stream) {
  return lmc::split::split_entry<lmc::i8, true>(a, B, H, Hkv, D, part_o,
                                                part_ml, nsplit, stream);
}
