// Absorbed multi-head latent attention (MLA, DeepSeek-V2/V3) over the dense
// latent pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmcache_tpu/ops/latent_attention.py::_latent_kernel
// (entry points latent_flash_attention and quantized_latent_flash_attention,
// through _latent_call's pallas_call) as lmc::latent::latent_sm90_fwd<bf16 or
// int8, dense, 32> of latent_sm90.cuh, which holds the contract, the design and
// every step of the body: blocks of 64 (token, head) rows, a TMA ring of
// latent tiles, S = Q K^T and O += P V as wgmma with S, P and O in
// registers, the two consumer warpgroups taking the tiles in turn and
// splitting O's 512 columns.
//
// Bound on an H100: a prefill of T tokens over S cached latents does
// 2 * H * (C + r) operations per live (token, key) pair on about 2 * S * C
// bytes of latents, far above the card's ~295 FLOP/byte ridge, so it is
// bound by the tensor-core operations. Decode (T == 1) does 2 * H * (C + r)
// / (2 * C) ~ 30 operations per latent byte at H = 16 and is bound by those
// bytes; the same body serves it, one block a sequence (at H 128 one
// block a 64 heads), each reading the sequence's latents once.

#include "latent_sm90.cuh"

// Plain C entry points, bound with ctypes: the argument block (device
// pointers, strides in elements; the paged and split fields unused), the
// batch, the stream; they return a cudaError_t (0 on success).
extern "C" int lmc_latent_attention_bf16(const lmc::LatentArgs* a, int B,
                                         void* stream) {
  return lmc::latent::launch<lmc::bf16, false, 32>(a, B, 1, stream);
}

extern "C" int lmc_latent_attention_int8(const lmc::LatentArgs* a, int B,
                                         void* stream) {
  return lmc::latent::launch<lmc::i8, false, 32>(a, B, 1, stream);
}
