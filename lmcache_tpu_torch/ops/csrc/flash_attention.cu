// Causal GQA flash attention over a prefilled KV buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmcache_tpu/ops/attention.py::_flash_kernel
// (entry point flash_attention, pallas_call at attention.py:361), with its
// options: a sliding or chunked window, a score softcap, attention sinks and
// a pool row chosen on the device (kv_slot). The kernel is
// lmc::flash_fwd<D, bf16, SOFTCAP> of flash_common.cuh, which holds the
// contract, the block layout and every step of the body, shared with
// quantized_flash_attention.cu and flash_stream_attention.cu.
//
// Bound on an H100: a prefill of T tokens over a context of S does
// 4 * H * D * (live key pairs) operations on T*H*D + 2*S*H_kv*D*2 bytes, far
// above the card's ~295 FLOP/byte ridge, so prefill is bound by operations:
// the products run on the tensor cores (WMMA bf16 16x16x16, fp32
// accumulate). Decode (T == 1) does ~G*4 operations per K/V byte and is bound
// by the K/V bytes: one block holds the whole GQA group of a KV head, so every
// K/V tile is read from device memory once per (sequence, KV head), not once
// per query head. The key loop runs from the tile that holds the window's
// first key to the causal limit, so masked tiles are neither read nor
// computed: with a window the bytes and operations follow the window, not the
// context. A split over the keys (to fill 132 SMs at small B * H_kv), TMA
// loads and wgmma are left to a later revision.

#include "flash_common.cuh"

// Plain C entry point, bound with ctypes: the argument block (device
// pointers, strides in elements), the sizes it does not hold, the stream;
// returns a cudaError_t (0 on success).
extern "C" int lmc_flash_attention_bf16(const lmc::FlashArgs* a, int B,
                                        int H, int Hkv, int D, void* stream) {
  return lmc::flash_entry<lmc::bf16>(a, B, H, Hkv, D, stream);
}
