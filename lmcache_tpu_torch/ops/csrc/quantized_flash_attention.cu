// Flash attention that reads an int8 KV buffer and dequantizes it inside the
// kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// lmcache_tpu/ops/quantized_attention.py::_qflash_kernel (entry point
// quantized_flash_attention): the contract of flash_attention.cu over int8
// K/V symbols [B, H_kv, S, D] with one fp32 scale per (sequence, token),
// shared by all heads, in [B, S] buffers with their own strides (a slot
// view of the serving pool's [L, 2, B, S] scales). The scales never touch
// the K/V tiles:
//     s[i, j]  = (q_i . k_int_j) * (k_scale[j] * sm_scale)
//     out[i]  += bf16(p[i, j] * v_scale[j]) * v_int_j
// with the row sum l taken from p before the V scale. Every option of
// flash_attention.cu (window, chunks, softcap, sinks, kv_slot) runs here.
//
// Two paths, which the wrapper (ops/quantized_attention.py) picks by the
// rows of a launch, T * G, as flash_attention.cu's:
// - more than 16 rows (prefill): the Hopper body of flash_sm90.cuh over
//   int8 K/V. Q stays bf16, as in the TPU kernel, and wgmma has no
//   bf16 x int8 form, so the symbols are converted exactly to bf16 on the
//   chip: TMA brings the int8 tiles into a staging ring, the producer
//   warpgroup's three otherwise idle warps write them as bf16 panels in the
//   swizzled layout the consumers' wgmma descriptors read, with the tile's
//   K and V scales beside them; the two consumer warpgroups run S = Q K^T
//   and O += P V as wgmma with S, P and O in registers. Bound by the
//   tensor-core operations (4 * H * D a live key pair, as in bf16): int8
//   halves the K/V bytes, which were not the bound.
// - at most 16 rows (every decode step of the dense engines over the int8
//   pool): the key-split decode of flash_split.cuh over int8 chunks
//   (cp.async, the scales beside them, the same absolute split points of
//   SPLIT keys), then flash_attention.cu's combine kernel, unchanged.
//   Bound by the bytes: D bytes of K and of V a key and KV head and 8
//   bytes of scales a key, about half of bf16's 4 * D, so the least time
//   of a decode over S keys is (2 * D * H_kv + 8) * S * B / 3.35 TB/s.

#include "flash_sm90.cuh"
#include "flash_split.cuh"

// Plain C entry points, bound with ctypes; each returns a cudaError_t (0 on
// success) and launches on `stream`.

// The prefill body: the argument block (device pointers, strides in
// elements) and the sizes it does not hold.
extern "C" int lmc_qflash_attention_int8(const lmc::FlashArgs* a, int B,
                                         int H, int Hkv, int D, void* stream) {
  using lmc::i8;
  using lmc::sm90::launch;
  if (lmc::flash_bad_sizes(a, B, H, Hkv) || a->k_scale == nullptr ||
      a->v_scale == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const bool cap = a->softcap > 0.f;
  switch (D) {
    case 64:
      return cap ? launch<64, 2, true, i8>(*a, B, Hkv, s)
                 : launch<64, 2, false, i8>(*a, B, Hkv, s);
    case 96:
      return cap ? launch<96, 2, true, i8>(*a, B, Hkv, s)
                 : launch<96, 2, false, i8>(*a, B, Hkv, s);
    case 128:
      return cap ? launch<128, 2, true, i8>(*a, B, Hkv, s)
                 : launch<128, 2, false, i8>(*a, B, Hkv, s);
    case 256:
      return cap ? launch<256, 2, true, i8>(*a, B, Hkv, s)
                 : launch<256, 2, false, i8>(*a, B, Hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The int8 split decode's first kernel: partials of T * G <= 16 rows into
// part_o [B, H_kv, nsplit, T * G, D] and part_ml [.., 2] (m, l), fp32, with
// nsplit = max(1, ceil(S / SPLIT)); lmc_flash_combine_partials of
// flash_attention.cu finishes them.
extern "C" int lmc_qflash_decode_split_int8(const lmc::FlashArgs* a, int B,
                                            int H, int Hkv, int D,
                                            void* part_o, void* part_ml,
                                            int nsplit, void* stream) {
  return lmc::split::split_entry<lmc::i8>(a, B, H, Hkv, D, part_o, part_ml,
                                          nsplit, stream);
}
