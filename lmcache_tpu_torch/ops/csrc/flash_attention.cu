// Causal GQA flash attention over a prefilled KV buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmcache_tpu/ops/attention.py::_flash_kernel
// (entry point flash_attention, pallas_call at attention.py:361), with its
// options: a sliding or chunked window, a score softcap, attention sinks and
// a pool row chosen on the device (kv_slot). Contract: flash_args.cuh.
//
// Two paths, which the wrapper (ops/attention.py) picks by the rows of a
// launch, T * G:
// - more than 16 rows (prefill): the Hopper body of flash_sm90.cuh (TMA
//   ring, wgmma, S, P and O in registers), with the softcap a variant of
//   its own so that the others carry no tanh. Bound by the tensor-core
//   operations (4 * H * D a live key pair, far above the card's ~295
//   FLOP/byte ridge).
// - at most 16 rows (every decode step of the dense engines): the
//   key-split decode of flash_split.cuh, partials over splits of SPLIT
//   keys, then the combine kernel of combine.cuh (its entry point is this
//   file's), which merges the partials of a row in a fixed order and joins the sinks once. Bound by the K/V bytes
//   (~G * 4 operations a byte): one block a (sequence, KV head) walking all
//   its keys, as the TPU kernel's program does, would leave B * H_kv
//   blocks on 132 SMs; the split puts B * H_kv * S / SPLIT blocks on them.

#include "combine.cuh"
#include "flash_split.cuh"
#include "flash_sm90.cuh"

// Plain C entry points, bound with ctypes; each returns a cudaError_t (0 on
// success) and launches on `stream`.

// The prefill body: the argument block (device pointers, strides in
// elements) and the sizes it does not hold.
extern "C" int lmc_flash_attention_bf16(const lmc::FlashArgs* a, int B,
                                        int H, int Hkv, int D, void* stream) {
  using lmc::sm90::launch;
  if (lmc::flash_bad_sizes(a, B, H, Hkv)) return cudaErrorInvalidValue;
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const bool cap = a->softcap > 0.f;
  switch (D) {
    case 64:
      return cap ? launch<64, 2, true>(*a, B, Hkv, s)
                 : launch<64, 2, false>(*a, B, Hkv, s);
    case 96:
      return cap ? launch<96, 2, true>(*a, B, Hkv, s)
                 : launch<96, 2, false>(*a, B, Hkv, s);
    case 128:
      return cap ? launch<128, 2, true>(*a, B, Hkv, s)
                 : launch<128, 2, false>(*a, B, Hkv, s);
    case 256:
      return cap ? launch<256, 2, true>(*a, B, Hkv, s)
                 : launch<256, 2, false>(*a, B, Hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The split decode's first kernel: partials of T * G <= 16 rows into
// part_o [B, H_kv, nsplit, T * G, D] and part_ml [.., 2] (m, l), fp32, with
// nsplit = max(1, ceil(S / SPLIT)).
extern "C" int lmc_flash_decode_split_bf16(const lmc::FlashArgs* a, int B,
                                           int H, int Hkv, int D,
                                           void* part_o, void* part_ml,
                                           int nsplit, void* stream) {
  return lmc::split::split_entry<lmc::bf16>(a, B, H, Hkv, D, part_o, part_ml,
                                            nsplit, stream);
}

// The split decode's second kernel: out [B, T, H, D] bf16 (strides ob, ot,
// oh in elements, unit along D) from the partials; sinks [H] fp32 or null.
extern "C" int lmc_flash_combine_partials(const void* part_o,
                                          const void* part_ml,
                                          const void* sinks, void* out,
                                          int B, int T, int G, int Hkv, int D,
                                          int nsplit, long long ob,
                                          long long ot, long long oh,
                                          void* stream) {
  return lmc::split::launch_combine(part_o, part_ml, sinks, out, B, T, G, Hkv,
                                    D, nsplit, ob, ot, oh, stream);
}
