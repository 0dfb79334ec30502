// Range encoder for CacheGen containers, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmcache_tpu/ops/range_encode.py::_encode_tile_kernel
// (entry point encode_streams_pallas -> _encode_jit, pallas_call at
// range_encode.py:363). It encodes S independent streams of n uint8 symbols,
// each against its own 33-entry uint16 CDF (the implied final bound 65536 is
// never read), and is byte-identical with
// codec/csrc/lmtc_codec.cc::encode_stream: one thread runs exactly that
// recurrence for one stream.
//
// The TPU kernel's symbol packing, per-entropy-class strides and fixed
// renormalization unroll have no counterpart. Each stream writes into its
// row of a device buffer [S, out_stride] with the C++ coder's own worst-case
// stride, 2 * n + 16, and reports -1 in lens on overflow, as the C++ coder
// does; the wrapper compacts the rows on the card, so only the coded bytes
// and the lengths cross to the host.
//
// Bound on an H100: per symbol a 32-bit division by a constant (a shift), two
// CDF lookups in shared memory, two multiplies and the renormalization test,
// 15 integer operations, and 8 more and one byte store per coded byte: bound by
// integer operations and the latency of the serial per-stream chain, not by
// the bytes. Each block stages its 128 streams' CDF rows in shared memory
// with a coalesced load. Several streams a thread and coalesced transposed
// layouts are left to a later revision.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr uint32_t kBot = 1u << 16;
constexpr int kBins = 32;  // CDF width of the container format: 33 entries
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    range_encode_kernel(const uint8_t* __restrict__ symbols,
                        const uint16_t* __restrict__ cdf, int n_streams,
                        int n_symbols, uint8_t* __restrict__ out,
                        int out_stride, int32_t* __restrict__ lens) {
  __shared__ uint16_t s_cdf[kThreads * (kBins + 1)];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(
      min(static_cast<int64_t>(kThreads), n_streams - first));
  const uint16_t* src = cdf + first * (kBins + 1);
  for (int i = threadIdx.x; i < rows * (kBins + 1); i += kThreads) {
    s_cdf[i] = src[i];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;

  const int64_t s = first + threadIdx.x;
  const uint16_t* c = s_cdf + threadIdx.x * (kBins + 1);
  const uint8_t* in = symbols + s * static_cast<int64_t>(n_symbols);
  uint8_t* o = out + s * static_cast<int64_t>(out_stride);

  uint32_t low = 0, range = 0xFFFFFFFFu;
  int pos = 0;
  for (int t = 0; t < n_symbols; ++t) {
    const int x = in[t];
    const uint32_t cf = x < kBins ? c[x] : 65536u;
    const uint32_t cfn = x + 1 < kBins ? c[x + 1] : 65536u;
    range /= 65536u;
    low += cf * range;
    range *= (cfn - cf);
    // renormalize (carry-less: clamp range at low-boundary crossings)
    while ((low ^ (low + range)) < kTop ||
           (range < kBot && ((range = -low & (kBot - 1)), true))) {
      if (pos >= out_stride) {
        lens[s] = -1;
        return;
      }
      o[pos++] = static_cast<uint8_t>(low >> 24);
      low <<= 8;
      range <<= 8;
    }
  }
  for (int i = 0; i < 4; ++i) {
    if (pos >= out_stride) {
      lens[s] = -1;
      return;
    }
    o[pos++] = static_cast<uint8_t>(low >> 24);
    low <<= 8;
  }
  lens[s] = pos;
}

}  // namespace

// Plain C entry point, bound with ctypes. symbols: uint8 [n_streams,
// n_symbols]; cdf: uint16 [n_streams, 33]; out: uint8 [n_streams,
// out_stride]; lens: int32 [n_streams] (-1 on overflow). Launches on `stream`
// and returns a cudaError_t (0 on success).
extern "C" int lmc_range_encode(const uint8_t* symbols, const uint16_t* cdf,
                                int n_streams, int n_symbols, uint8_t* out,
                                int out_stride, int32_t* lens, void* stream) {
  if (n_streams <= 0) return 0;
  const int blocks = (n_streams + kThreads - 1) / kThreads;
  range_encode_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      symbols, cdf, n_streams, n_symbols, out, out_stride, lens);
  return static_cast<int>(cudaGetLastError());
}
