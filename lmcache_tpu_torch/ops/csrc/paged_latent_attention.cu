// Absorbed multi-head latent attention over a paged latent arena, for
// Hopper (sm_90a): the two paged MLA kernels.
//
// Replaces the TPU kernels
// lmcache_tpu/ops/paged_latent_attention.py::_paged_latent_kernel (entry
// points paged_latent_attention and quantized_paged_latent_attention) as
// lmc::latent_fwd<BM, KV, 1>: one page per step (the tile is one
// page), the analog of paged_attention.cu; and ::_paged_latent_dma_kernel
// (entry points paged_latent_attention_dma and
// quantized_paged_latent_attention_dma) as lmc::latent_fwd<BM, KV, 2>:
// tiles of several page slots (as many keys as shared memory holds twice),
// gathered through the page table with cp.async, the next tile's loads in
// flight while this one is computed, the analog of
// paged_stream_attention.cu. Both walk the live page slots only (up to the
// block's causal limit and kv_len); page-table entries past them are never
// read, and a page id outside the pool reads as zeros. Contract and body:
// latent_common.cuh.
//
// What carries over from the TPU kernels is the work per step, not their
// layout: the 128-lane pad of the arena (the TPU's DMA alignment) is not
// read, only the first C columns of a row; runs of consecutive page ids are
// not coalesced (each row is gathered by address arithmetic); the TPU's
// N_BUF-deep DMA ring is a double buffer here. Bound on an H100: prefill by
// the operations (2 * H * (C + r) a live pair), decode at H = 16 by the
// latent bytes (~30 operations a byte).

#include "latent_common.cuh"

extern "C" int lmc_paged_latent_attention_bf16(const lmc::LatentArgs* a,
                                               int B, int BM, void* stream) {
  return lmc::latent_entry<lmc::bf16, 1>(a, B, BM, stream);
}

extern "C" int lmc_paged_latent_attention_int8(const lmc::LatentArgs* a,
                                               int B, int BM, void* stream) {
  return lmc::latent_entry<lmc::i8, 1>(a, B, BM, stream);
}

extern "C" int lmc_paged_latent_stream_attention_bf16(
    const lmc::LatentArgs* a, int B, int BM, void* stream) {
  return lmc::latent_entry<lmc::bf16, 2>(a, B, BM, stream);
}

extern "C" int lmc_paged_latent_stream_attention_int8(
    const lmc::LatentArgs* a, int B, int BM, void* stream) {
  return lmc::latent_entry<lmc::i8, 2>(a, B, BM, stream);
}

// Shared memory (bytes) of one block, so that the wrapper can size the row
// block and the tile before it launches.
extern "C" int lmc_paged_latent_attention_smem_bytes(int BM, int C, int r,
                                                     int tn, int stages) {
  return lmc::latent_smem_bytes(BM, C, r, tn, stages);
}
