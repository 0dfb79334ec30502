// What the range encoder (kernel row 12) and decoder (row 11) share: the
// coder's constants and the per-block CDF table in shared memory.
//
// A block of kThreads threads codes kStreams streams, two a thread: streams
// tid and tid + kThreads, so that the lanes of a warp hold adjacent streams
// and each thread runs two independent serial chains (on an H100 80GB HBM3
// at 700 W, two a thread beat one a thread at every path shape: 0.376
// against 0.581 ms encoding a tinyllama store half, 0.392 against 0.520
// decoding a retrieve group, 0.796 against 0.871 decoding a
// DeepSeek-V2-Lite latent group). Each stream has its own 33-entry uint16 CDF (the implied
// final bound 65536 is never read). The block stages its streams' CDF rows
// as they lie in global memory (a coalesced copy) and lays them out
// transposed, table[x * kStreams + stream]: the 32 lanes of a warp
// reading entry x_lane of their own streams then hit 32 distinct banks for
// any x_lane, where row-major rows 66 bytes apart collide.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace lmc_range {

constexpr uint32_t kTop = 1u << 24;
constexpr uint32_t kBot = 1u << 16;
constexpr int kBins = 32;  // CDF width of the container format: 33 entries
constexpr int kThreads = 128;
constexpr int kStreams = 2 * kThreads;  // streams a block

struct CdfSmem {
  uint16_t raw[kStreams * (kBins + 1)];  // the rows as in global memory
  uint16_t table[kBins * kStreams];      // [x][stream], x < 32
};

// Stage rows [first, first + rows) of cdf [n_streams, 33] and transpose them
// into sm.table. The transposing reads of the raw rows (33 halfwords apart)
// fall into distinct banks too, so neither step conflicts. Every thread of
// the block calls it.
__device__ __forceinline__ void load_cdf(const uint16_t* __restrict__ cdf,
                                         int64_t first, int rows,
                                         CdfSmem& sm) {
  const uint16_t* src = cdf + first * (kBins + 1);
  for (int i = threadIdx.x; i < rows * (kBins + 1); i += kThreads) {
    sm.raw[i] = __ldg(src + i);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < rows; j += kThreads) {
#pragma unroll 8
    for (int x = 0; x < kBins; ++x) {
      sm.table[x * kStreams + j] = sm.raw[j * (kBins + 1) + x];
    }
  }
  __syncthreads();
}

}  // namespace lmc_range
