// Pieces shared by every attention kernel of the port (through
// flash_args.cuh, latent_args.cuh and combine.cuh): the element types, the
// TPU kernels' masking constant, the shared memory a block may use and the
// one-time raise of a kernel's dynamic shared-memory limit.
//
// Arena layout of the paged kernels, as lmcache_tpu/models/paged.py builds
// it: K and V pools [P, H_kv, page, D] (head-major pages; any strides with
// unit stride along D, so a layer's slice pool[l, 0] of the arena is read
// in place), int8 arenas with one fp32 scale per (page, token) in [P, page]
// pools shared by all heads. page_table int32 [B, NP] names the pages of
// each sequence.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace lmc {

using bf16 = __nv_bfloat16;
using i8 = signed char;

constexpr float NEG_INF = -1e30f;  // the TPU kernels' masking constant
// shared memory a block may use on sm_90 (227 KB)
constexpr int SMEM_LIMIT = 232448;

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

}  // namespace lmc
