// Attention over a page-table-indexed KV arena, one page per step on the
// TPU, for Hopper (sm_90a): the general paged kernel, head dims 64, 96, 128
// and 256.
//
// Replaces the TPU kernels lmcache_tpu/ops/paged_attention.py::_paged_kernel
// (entry point paged_attention, row 4) and ::_paged_kernel_q (entry point
// quantized_paged_attention, row 5); both share _paged_body there.
// Contract: q [B, T, H, D] attends to the pages page_table[b, :] of the K/V
// pools [P, H_kv, page, D] under
//     kpos <= min(q_offset[b] + t, kv_len[b] - 1)  and, with a window W,
//     kpos >  q_offset[b] + t - W  (sliding) or
//     kpos / W == (q_offset[b] + t) / W  (chunked),
// the scores softcapped (cap * tanh(s / cap)) before the mask where a cap
// is set, online softmax in fp32, P rounded to bf16 before the PV product,
// the attention sinks [H] joined to the normalization, 0 for a row that
// sees no key (so also for kv_len == 0). An int8 arena carries one
// fp32 scale per (page, token) in [P, page] pools shared by all heads: the
// K scale multiplies the score column, the V scale P's column after the row
// sum.
//
// Both arenas run the Hopper body of rows 1-3 (flash_sm90.cuh) with the
// arena as its tile source, read in place through the page table: a TMA
// box a page piece (and, bf16, a panel), the page ids loaded by the
// producer warp, two wgmma consumer warpgroups with S, P and O in
// registers, the ring of row 1 (2 stages). Over int8 the pieces land in
// row 3's staging ring and the producer warpgroup's three other warps
// convert them exactly to bf16 panels, with each key's scales read
// through the page table. Launches of at most 16 rows T * G (every decode
// step) run the key-split decode of flash_split.cuh over the arena
// (cp.async copies through the page table, int8 with the scales beside
// them, splits at absolute multiples of 256 keys), and flash_attention.cu's
// combine merges the partials. The TPU kernel steps a sequential grid axis
// over every page-table slot and pins the DMA of dead slots to a live page;
// here only the live pieces are read. Bound on an H100: prefill by the
// tensor-core operations (4 H D a live pair), decode by the live K/V bytes
// (~4 G operations a byte, int8 twice that; Phi-3 at G 1: one block a
// (sequence, KV head) walking its ~33 window pages would leave 64 blocks
// on 132 SMs, the split puts B * H_kv * splits on them).

#include "flash_sm90.cuh"
#include "flash_split.cuh"

namespace {

// The body at head dim D, with the softcap a variant of its own (as row 1's)
// so that the others carry no tanh.
template <int D, typename KV>
cudaError_t paged_launch(const lmc::FlashArgs& a, int B, int Hkv,
                         cudaStream_t s) {
  using lmc::sm90::launch;
  return a.softcap > 0.f ? launch<D, 2, true, KV, true>(a, B, Hkv, s)
                         : launch<D, 2, false, KV, true>(a, B, Hkv, s);
}

template <typename KV>
int body(const lmc::FlashArgs* a, int B, int H, int Hkv, int D,
         void* stream) {
  if (lmc::flash_bad_sizes(a, B, H, Hkv)) return cudaErrorInvalidValue;
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return paged_launch<64, KV>(*a, B, Hkv, s);
    case 96:
      return paged_launch<96, KV>(*a, B, Hkv, s);
    case 128:
      return paged_launch<128, KV>(*a, B, Hkv, s);
    case 256:
      return paged_launch<256, KV>(*a, B, Hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes; each returns a cudaError_t (0 on
// success) and launches on `stream`.

// Rows 4 and 5's prefill body: the argument block (device pointers, strides
// in elements, the page-table fields set; int8: the scale pools' strides
// in ksb, kss, vsb, vss) and the sizes it does not hold.
extern "C" int lmc_paged_attention_bf16(const lmc::FlashArgs* a, int B,
                                        int H, int Hkv, int D, void* stream) {
  return body<lmc::bf16>(a, B, H, Hkv, D, stream);
}

extern "C" int lmc_paged_attention_int8(const lmc::FlashArgs* a, int B,
                                        int H, int Hkv, int D, void* stream) {
  return body<lmc::i8>(a, B, H, Hkv, D, stream);
}

// Rows 4 and 5's split decode, its first kernel: partials of T * G <= 16
// rows into part_o [B, H_kv, nsplit, T * G, D] and part_ml [.., 2] (m, l),
// fp32, with nsplit = max(1, ceil(NP * page / SPLIT));
// lmc_flash_combine_partials of flash_attention.cu merges them.
extern "C" int lmc_paged_attention_decode_split_bf16(
    const lmc::FlashArgs* a, int B, int H, int Hkv, int D, void* part_o,
    void* part_ml, int nsplit, void* stream) {
  return lmc::split::split_entry<lmc::bf16, true>(a, B, H, Hkv, D, part_o,
                                                  part_ml, nsplit, stream);
}

extern "C" int lmc_paged_attention_decode_split_int8(
    const lmc::FlashArgs* a, int B, int H, int Hkv, int D, void* part_o,
    void* part_ml, int nsplit, void* stream) {
  return lmc::split::split_entry<lmc::i8, true>(a, B, H, Hkv, D, part_o,
                                                part_ml, nsplit, stream);
}
