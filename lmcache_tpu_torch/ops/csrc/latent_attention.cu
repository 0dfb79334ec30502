// Absorbed multi-head latent attention (MLA, DeepSeek-V2/V3) over the dense
// latent pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmcache_tpu/ops/latent_attention.py::_latent_kernel
// (entry points latent_flash_attention and quantized_latent_flash_attention,
// through _latent_call's pallas_call) as lmc::latent_fwd<BM, bf16, 1, false>
// and lmc::latent_fwd<BM, int8, 1, false> of latent_common.cuh, which holds
// the contract, the block layout and every step of the body.
//
// Bound on an H100: a prefill of T tokens over S cached latents does
// 2 * H * (C + r) operations per live (token, key) pair on about 2 * S * C
// bytes of latents, far above the card's ~295 FLOP/byte ridge, so it is
// bound by operations: both products run on the tensor cores (WMMA bf16,
// fp32 accumulate), and each key tile is read once per block of BM
// (head, token) rows for both of them. Decode (T == 1) does 2 * H * (C + r)
// / (2 * C) ~ 30 operations per latent byte at H = 16 and is bound by bytes
// there; a block holds all H heads of a sequence, so the latent stream is
// read once per sequence (at H = 128, once per 32 heads). The key loop stops
// at the block's last visible key. A split over the keys (to fill 132 SMs
// at decode), O in registers, TMA and wgmma are left to a later revision.

#include "latent_common.cuh"

// Plain C entry points, bound with ctypes: the argument block (device
// pointers, strides in elements), the batch, the row block (16 or 32), the
// stream; they return a cudaError_t (0 on success).
extern "C" int lmc_latent_attention_bf16(const lmc::LatentArgs* a, int B,
                                         int BM, void* stream) {
  return lmc::latent_entry<lmc::bf16, 1, false>(a, B, BM, stream);
}

extern "C" int lmc_latent_attention_int8(const lmc::LatentArgs* a, int B,
                                         int BM, void* stream) {
  return lmc::latent_entry<lmc::i8, 1, false>(a, B, BM, stream);
}

// Shared memory (bytes) of one block, so that the wrapper can size the row
// block and the tile before it launches.
extern "C" int lmc_latent_attention_smem_bytes(int BM, int C, int r, int tn,
                                               int stages) {
  return lmc::latent_smem_bytes(BM, C, r, tn, stages);
}
