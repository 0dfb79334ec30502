// Flash attention that reads an int8 KV buffer and dequantizes it inside the
// kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// lmcache_tpu/ops/quantized_attention.py::_qflash_kernel (entry point
// quantized_flash_attention) as lmc::flash_fwd<D, int8, SOFTCAP> of
// flash_common.cuh. Contract of flash_attention.cu over int8 K/V
// symbols [B, H_kv, S, D] with one fp32 scale per (sequence, token), shared
// by all heads, in [B, S] buffers with their own strides (a slot view of the
// serving pool's [L, 2, B, S] scales). The scales never touch the K/V tiles:
//     s[i, j]  = (q_i . k_int_j) * (k_scale[j] * sm_scale)
//     out[i]  += (p[i, j] * v_scale[j]) * v_int_j
// The symbols are converted to bf16 on the way into shared memory (exact),
// the K scale multiplies score columns in fp32 before softcap and mask, the
// row sum is taken before the V scale multiplies the probability columns,
// and P goes to bf16 after that multiply. Every option of flash_attention.cu
// (window, chunks, softcap, sinks, kv_slot) runs through the WMMA body of
// flash_common.cuh.
//
// Bound on an H100: as flash_attention.cu, with half the K/V bytes plus 8
// bytes of scales per key. Decode is bound by those bytes; prefill by the
// tensor-core operations, which run in bf16 as before. Loads are synchronous
// (int8 rows pass through registers to be converted); a split over the keys,
// an int8 tensor-core product and wgmma are left to a later revision.

#include "flash_common.cuh"

// Plain C entry point, bound with ctypes: the argument block (device
// pointers, strides in elements), the sizes it does not hold, the stream;
// returns a cudaError_t (0 on success).
extern "C" int lmc_qflash_attention_int8(const lmc::FlashArgs* a, int B,
                                         int H, int Hkv, int D, void* stream) {
  return lmc::flash_entry<lmc::i8>(a, B, H, Hkv, D, stream);
}
