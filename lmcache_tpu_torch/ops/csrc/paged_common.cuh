// Shared pieces of the paged-attention kernels (paged_attention.cu,
// paged_stream_attention.cu): the WMMA bodies' argument block and page
// loaders (int8 arenas; the bf16 arenas run flash_sm90.cuh and
// flash_split.cuh), and the cp.async wrappers.
//
// Arena layout, as lmcache_tpu/models/paged.py builds it: K and V pools
// [P, H_kv, page, D] (head-major pages; any strides with unit stride along
// D, so a layer's slice pool[l, 0] of the arena is read in place), int8
// arenas with one fp32 scale per (page, token) in [P, page] pools shared by
// all heads. page_table int32 [B, NP] names the pages of each sequence.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <atomic>

namespace lmc {

using bf16 = __nv_bfloat16;
using i8 = signed char;

constexpr float NEG_INF = -1e30f;  // the TPU kernels' masking constant
// shared memory a block may use on sm_90 (227 KB)
constexpr int SMEM_LIMIT = 232448;

struct PagedArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const float* k_scale;  // int8 arenas only
  const float* v_scale;
  const int* page_table;
  const int* q_offset;
  const int* kv_len;
  int T, G, NP, P, page;
  int window;  // sliding window in tokens; <= 0: none
  int sp;      // page slots per key tile (stream kernel)
  // strides in elements: q/out [B, T, H, D], pools [P, H_kv, page, D],
  // scale pools [P, page]
  long long qb, qt, qh, kp, kh, ks, vp, vh, vs, ob, ot, oh, scp, svp;
  float scale;
};

template <typename KV>
struct Vec;  // elements per 16-byte load
template <>
struct Vec<bf16> {
  static constexpr int N = 8;
};
template <>
struct Vec<i8> {
  static constexpr int N = 16;
};

template <int N>
__device__ __forceinline__ void store_zero(bf16* dst) {
  const uint4 z = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < N; i += 8) *reinterpret_cast<uint4*>(dst + i) = z;
}

// 16 int8 symbols of a K/V row, already in registers, into the bf16 tile,
// exactly; the last argument only names the row's type
__device__ __forceinline__ void store_converted(bf16* dst, uint4 raw, i8) {
  const i8* c = reinterpret_cast<const i8*>(&raw);
  __align__(16) bf16 tmp[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    tmp[i] = __float2bfloat16_rn(static_cast<float>(c[i]));
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tmp);
  *reinterpret_cast<uint4*>(dst + 8) = *reinterpret_cast<const uint4*>(tmp + 8);
}

// 16 bytes of a pool row into the bf16 tile
template <typename KV>
__device__ __forceinline__ void load_convert(bf16* dst, const KV* src) {
  store_converted(dst, *reinterpret_cast<const uint4*>(src), KV());
}

// the same at the stream kernel's asynchronous load points: int8 rows have
// to pass through registers to be converted, so they load synchronously
__device__ __forceinline__ void load_async(bf16* dst, const i8* src) {
  load_convert(dst, src);
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raise a kernel's dynamic shared-memory limit once per device (it is a
// per-device attribute of the function), not before every launch.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, int bytes,
                             std::atomic<int>* raised_to) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>& have = raised_to[dev & 63];
  if (have.load(std::memory_order_relaxed) >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  have.store(bytes, std::memory_order_relaxed);
  return cudaSuccess;
}

// sizes no launch can take (the wrapper refuses them first)
inline bool bad_sizes(int B, int T, int H, int Hkv, int NP, int P, int page,
                      int sp) {
  return Hkv <= 0 || H % Hkv != 0 || NP <= 0 || P <= 0 || page <= 0 ||
         page % 16 != 0 || sp <= 0 || B < 0 || T < 0;
}

}  // namespace lmc

// The C interface shared by the four entry points (bound with ctypes):
// device pointers, sizes, strides in elements; returns a cudaError_t.
#define LMC_PAGED_PARAMS                                                     \
  const void *q, const void *k, const void *v, void *out,                    \
      const void *k_scale, const void *v_scale, const void *page_table,      \
      const void *q_offset, const void *kv_len, int B, int T, int H,         \
      int Hkv, int D, int NP, int P, int page, int window, int sp,           \
      long long sqb, long long sqt, long long sqh, long long skp,            \
      long long skh, long long sks, long long svp, long long svh,            \
      long long svs, long long sob, long long sot, long long soh,            \
      long long sscp, long long ssvp, float scale, void *stream

#define LMC_PAGED_ARGS_INIT                                                  \
  lmc::PagedArgs a;                                                          \
  a.q = q;                                                                   \
  a.k = k;                                                                   \
  a.v = v;                                                                   \
  a.out = out;                                                               \
  a.k_scale = static_cast<const float*>(k_scale);                            \
  a.v_scale = static_cast<const float*>(v_scale);                            \
  a.page_table = static_cast<const int*>(page_table);                        \
  a.q_offset = static_cast<const int*>(q_offset);                            \
  a.kv_len = static_cast<const int*>(kv_len);                                \
  a.T = T;                                                                   \
  a.G = H / Hkv;                                                             \
  a.NP = NP;                                                                 \
  a.P = P;                                                                   \
  a.page = page;                                                             \
  a.window = window;                                                         \
  a.sp = sp;                                                                 \
  a.qb = sqb;                                                                \
  a.qt = sqt;                                                                \
  a.qh = sqh;                                                                \
  a.kp = skp;                                                                \
  a.kh = skh;                                                                \
  a.ks = sks;                                                                \
  a.vp = svp;                                                                \
  a.vh = svh;                                                                \
  a.vs = svs;                                                                \
  a.ob = sob;                                                                \
  a.ot = sot;                                                                \
  a.oh = soh;                                                                \
  a.scp = sscp;                                                              \
  a.svp = ssvp;                                                              \
  a.scale = scale
