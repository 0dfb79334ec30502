// Range decoder for CacheGen containers, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmcache_tpu/ops/range_decode.py::_decode_tile_kernel
// (entry point decode_streams_pallas, pallas_call at range_decode.py:426).
// It decodes S independent streams, each n symbols against its own 33-entry
// uint16 CDF (the implied final bound 65536 is never read), and is
// symbol-exact with codec/csrc/lmtc_codec.cc::decode_stream: one thread runs
// exactly that recurrence for one stream.
//
// What the TPU kernel does for Mosaic (lane-packed words, one-hot gathers,
// an f32 division ladder, a fixed renormalization unroll with an overflow
// flag, a zero-padded [S, stride] payload) has no counterpart: the division
// is the native 32-bit one (guarded by max(range, 1) so that a corrupt
// container cannot fault), the renormalization loop has no bound, so no
// overflow is possible, and each thread reads its bytes from the
// concatenated payload through int64 offsets, with the coder's zero feed
// past the stream's end. A range can collapse to 0 only under a CDF that does
// not rise strictly, where the C++ coder never returns; the container parser
// (storage/serde/cachegen_serde.py::_parse_container) refuses such tables, and
// a direct caller that passes one gets zeros for the rest of the stream
// instead of a hung card.
//
// Bound on an H100: per symbol one 32-bit division (15 integer instructions
// besides I2F, MUFU.RCP and F2I), 31 compares and adds of the CDF search and
// about 15 more integer operations, so the work is bound by integer
// operations, not by the bytes (the payload and the tables are read once,
// the symbols written once). Each block stages its 128 streams' CDF rows in
// shared memory with a coalesced load; the search then reads shared memory.
// Several streams a
// thread (to overlap the division latency), coalesced transposed layouts and
// dequantization fused into the decoder are left to a later revision.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr uint32_t kBot = 1u << 16;
constexpr int kBins = 32;  // CDF width of the container format: 33 entries
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    range_decode_kernel(const uint8_t* __restrict__ payload,
                        const int64_t* __restrict__ offsets,
                        const uint16_t* __restrict__ cdf, int n_streams,
                        int n_symbols, uint8_t* __restrict__ out) {
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
  const uint8_t* in = payload + offsets[s];
  const int64_t len = offsets[s + 1] - offsets[s];
  uint8_t* o = out + s * static_cast<int64_t>(n_symbols);

  uint32_t low = 0, range = 0xFFFFFFFFu, code = 0;
  int64_t pos = 0;
  for (int i = 0; i < 4; ++i) {
    code = (code << 8) | (pos < len ? in[pos++] : 0u);
  }
  for (int t = 0; t < n_symbols; ++t) {
    range /= 65536u;
    uint32_t target = (code - low) / max(range, 1u);
    if (target > 65535u) target = 65535u;
    // the count of CDF entries <= target is the symbol (cdf[0] == 0)
    int lo = 0;
#pragma unroll
    for (int i = 1; i < kBins; ++i) lo += (c[i] <= target) ? 1 : 0;
    o[t] = static_cast<uint8_t>(lo);
    const uint32_t cf = c[lo];
    const uint32_t cfn = lo + 1 < kBins ? c[lo + 1] : 65536u;
    low += cf * range;
    range *= (cfn - cf);
    while (range != 0 &&
           ((low ^ (low + range)) < kTop ||
            (range < kBot && ((range = -low & (kBot - 1)), true)))) {
      code = (code << 8) | (pos < len ? in[pos++] : 0u);
      low <<= 8;
      range <<= 8;
    }
    if (range == 0) {
      // only a corrupt CDF (a decoded zero-width bin) collapses the range,
      // and there the C++ coder never returns: the stream decodes as zeros
      for (int u = t + 1; u < n_symbols; ++u) o[u] = 0;
      return;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. payload: the concatenated streams;
// offsets: int64 [n_streams + 1]; cdf: uint16 [n_streams, 33]; out: uint8
// [n_streams, n_symbols]. Launches on `stream` and returns a cudaError_t
// (0 on success).
extern "C" int lmc_range_decode(const uint8_t* payload, const int64_t* offsets,
                                const uint16_t* cdf, int n_streams,
                                int n_symbols, uint8_t* out, void* stream) {
  if (n_streams <= 0 || n_symbols <= 0) return 0;
  const int blocks = (n_streams + kThreads - 1) / kThreads;
  range_decode_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      payload, offsets, cdf, n_streams, n_symbols, out);
  return static_cast<int>(cudaGetLastError());
}
