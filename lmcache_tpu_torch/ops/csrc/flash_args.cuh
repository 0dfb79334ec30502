// The argument block of the dense attention kernels (flash_attention.cu,
// flash_stream_attention.cu, quantized_flash_attention.cu,
// prefill_variants.cu), mirrored on the host by a ctypes.Structure with the
// same fields in the same order (ops/attention.py::FlashArgs), and the sizes
// no launch of them can take.
//
// Contract of the dense kernels: q [B, T, H, D] bf16 attends to K/V rows
// [B, H_kv, S, D] (any strides with unit stride along D, so a slot view of
// the serving pool is read in place) under
//     kpos <= min(q_offset[b] + t, kv_len[b] - 1)
// and, with a window W, kpos > qpos - W ("sliding") or
// kpos / W == qpos / W ("chunked"). Online softmax in fp32, 0 for a row that
// sees no key. With kv_slot the K/V (and scale) row is kv_slot[0], read on
// the device, whatever b is. Over a paged arena (page_table set) key kpos
// of sequence b is row kpos % page of page page_table[b, kpos / page].

#pragma once

#include "paged_common.cuh"

namespace lmc {

// strides in elements
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const float* k_scale;  // int8 K/V only: one fp32 per (sequence, token)
  const float* v_scale;
  const int* q_offset;
  const int* kv_len;
  const float* sinks;  // [H] fp32 attention-sink logits, or null
  const int* kv_slot;  // [1] pool row that every query attends to, or null
  int T, G, S;
  int window;    // window or chunk size in tokens; <= 0: none
  int chunked;   // 0: sliding window, 1: block-diagonal chunks
  float softcap;  // scores -> cap * tanh(s / cap) before the mask; <= 0: none
  float scale;
  long long qb, qt, qh, kb, kh, ks, vb, vh, vs, ob, ot, oh;
  long long ksb, kss, vsb, vss;  // scale strides [B, S]
  // paged arena only (paged_attention.cu, paged_stream_attention.cu): K/V
  // are pools [P, H_kv, page, D] whose page is named by page_table
  // [B, NP] (kb, kh, ks: the strides of the page, head and row in page),
  // S = NP * page; box: rows of one TMA box, a divisor of page and tile
  const int* page_table;
  int NP, P, page, box;
};

// sizes no launch can take (the wrapper refuses them first)
inline bool flash_bad_sizes(const FlashArgs* a, int B, int H, int Hkv) {
  return a == nullptr || Hkv <= 0 || H <= 0 || H % Hkv != 0 ||
         a->G != H / Hkv || B < 0 || a->T < 0 || a->S < 0;
}

// The oldest key that a query at qpos sees under the window (0 without
// one); a later query sees no older key under either window kind.
__device__ __forceinline__ int window_start(const FlashArgs& a, int qpos) {
  if (a.window <= 0) return 0;
  return a.chunked ? qpos / a.window * a.window : max(qpos - a.window + 1, 0);
}

// Keys must lie above this under the window (kpos > limit).
__device__ __forceinline__ int window_floor(const FlashArgs& a, int qpos) {
  if (a.window <= 0) return -0x40000000;
  return a.chunked ? qpos / a.window * a.window - 1 : qpos - a.window;
}

}  // namespace lmc
