// The combine of the key-split decodes: the second kernel of row 1's and
// row 3's split decode (flash_attention.cu, flash_split.cuh) and of row
// 10's latent split decode (paged_latent_attention.cu, latent_sm90.cuh).
// Partials part_o [B, H_kv, nsplit, R, D] and part_ml [.., 2] (m, l) in
// fp32, R = T * G rows (token, head-in-group) of each (sequence, KV head);
// the latent decode is H_kv = 1, G = H, D = r. Out [B, T, H, D] bf16.

#pragma once

#include "paged_common.cuh"

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

// Check the sizes and launch the combine on `stream`: out (strides ob, ot,
// oh in elements, unit along D) from the partials; sinks [H] fp32 or null.
// Returns a cudaError_t.
inline int launch_combine(const void* part_o, const void* part_ml,
                          const void* sinks, void* out, int B, int T, int G,
                          int Hkv, int D, int nsplit, long long ob,
                          long long ot, long long oh, void* stream) {
  // (m, l) of a row's partials in the default 48 KB of shared memory
  if (B < 0 || T < 0 || G <= 0 || Hkv <= 0 || D <= 0 || D > 1024 ||
      nsplit <= 0 || nsplit > 6144) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0) return cudaSuccess;
  combine_partials_fwd<<<dim3(T * G, Hkv, B), D, 8 * nsplit,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<const float*>(sinks), static_cast<bf16*>(out), T, G, D,
      nsplit, ob, ot, oh);
  return cudaGetLastError();
}

}  // namespace split
}  // namespace lmc
