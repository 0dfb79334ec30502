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
//   keys, then this file's combine kernel, which merges the partials of a
//   row in a fixed order and joins the sinks once. Bound by the K/V bytes
//   (~G * 4 operations a byte): one block a (sequence, KV head) walking all
//   its keys, as the TPU kernel's program does, would leave B * H_kv
//   blocks on 132 SMs; the split puts B * H_kv * S / SPLIT blocks on them.

#include "flash_split.cuh"
#include "flash_sm90.cuh"

namespace lmc {
namespace split {

// One row (token, head-in-group) of one (sequence, KV head), a thread a
// column: the partials in split order, empty ones (l = 0) adding nothing
// (their O is never used), then the sinks joined to the normalization, as
// the body's end does. The partials' (m, l) are staged in shared memory
// first, so that the loop over the splits issues its O loads back to back.
__global__ void combine_partials_fwd(const float* part_o,
                                     const float* part_ml,
                                     const float* sinks, bf16* out, int T,
                                     int G, int D, int nsplit, long long ob,
                                     long long ot, long long oh) {
  extern __shared__ float sml[];  // [nsplit][2]
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x;
  const int R = T * G;
  const long long row0 =
      static_cast<long long>(b * gridDim.y + h) * nsplit * R + r;
  for (int s = d; s < nsplit; s += blockDim.x) {
    const long long i = row0 + static_cast<long long>(s) * R;
    sml[2 * s] = part_ml[2 * i];
    sml[2 * s + 1] = part_ml[2 * i + 1];
  }
  __syncthreads();
  float m = NEG_INF;
  for (int s = 0; s < nsplit; ++s) {
    if (sml[2 * s + 1] > 0.f) m = fmaxf(m, sml[2 * s]);
  }
  float l = 0.f, acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const float ls = sml[2 * s + 1];
    const float o = part_o[(row0 + static_cast<long long>(s) * R) * D + d];
    const float wgt = ls > 0.f ? expf(sml[2 * s] - m) : 0.f;
    l += wgt * ls;
    acc += ls > 0.f ? wgt * o : 0.f;
  }
  const int head = h * G + r % G;
  float inv = l > 0.f ? 1.f / l : 0.f;
  if (sinks != nullptr) {
    const float snk = sinks[head];
    const float m2 = fmaxf(m, snk);
    const float keep = expf(m - m2);
    inv = keep / (l * keep + expf(snk - m2));
  }
  out[b * ob + (r / G) * ot + head * oh + d] = __float2bfloat16(acc * inv);
}

}  // namespace split
}  // namespace lmc

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
  // (m, l) of a row's partials in the default 48 KB of shared memory
  if (B < 0 || T < 0 || G <= 0 || Hkv <= 0 || D <= 0 || D > 1024 ||
      nsplit <= 0 || nsplit > 6144) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0) return cudaSuccess;
  lmc::split::combine_partials_fwd<<<dim3(T * G, Hkv, B), D, 8 * nsplit,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<const float*>(sinks), static_cast<lmc::bf16*>(out), T, G,
      D, nsplit, ob, ot, oh);
  return cudaGetLastError();
}
