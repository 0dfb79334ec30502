// Range encoder for CacheGen containers, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmcache_tpu/ops/range_encode.py::_encode_tile_kernel
// (entry point encode_streams_pallas -> _encode_jit, pallas_call at
// range_encode.py:363). It encodes S independent streams of n uint8 symbols,
// each against its own 33-entry uint16 CDF, and is byte-identical with
// codec/csrc/lmtc_codec.cc::encode_stream: each stream runs exactly that
// recurrence, reports -1 on overflowing the C++ coder's worst case
// (2 * n + 16 bytes) and runs the renormalization loop unbounded, as it does.
//
// Bound on an H100: per symbol two CDF lookups, the range shift, two
// multiplies and the renormalization test, and per coded byte a few more
// integer operations: bound by integer operations, not by the bytes (the
// symbols are read once, the coded bytes written once). What the design does
// about it:
// - two streams a thread (range_coder.cuh: lanes hold adjacent streams),
//   both narrowed before either renormalizes, both renormalizing in one
//   branch-free loop, so that the two serial chains overlap;
// - the CDF rows transposed in shared memory, so that a warp's 64 lookups a
//   symbol step are conflict-free;
// - the symbols read 16 at a time with one 16-byte load a stream, the next
//   16 loaded while the current ones are coded (rows of n % 16 == 0; other
//   widths read bytes);
// - the coded bytes packed in registers and stored 16 at a time into the
//   stream's row of a staging buffer whose stride is a multiple of 16.
// The second kernel of the file, range_compact_kernel, copies each row's
// coded bytes to their place in the concatenated payload (offsets from an
// exclusive scan of the lengths): it reads only coded bytes.
//
// The TPU kernel's symbol packing, per-entropy-class strides and fixed
// renormalization unroll have no counterpart.

#include <cstdint>

#include <cuda_runtime.h>

#include "range_coder.cuh"

namespace {

using namespace lmc_range;

// One stream's coder state and its packed, not yet stored, coded bytes.
struct Enc {
  uint32_t low, range;
  int pos;                  // bytes emitted
  uint32_t acc;             // the last pos % 4 bytes, in its top bytes
  uint32_t q0, q1, q2, q3;  // the last words since a 16-byte store, q3 newest
  bool dead;                // overflowed its worst case
  uint8_t* row;             // its row of the staging buffer, 16-aligned
  const uint16_t* cdf;      // its column of the shared CDF table
};

// The byte low >> 24 into the packing registers, a 16-byte store when they
// fill. A byte at position cap or beyond overflows the worst case: the
// stream is dead (more() then ends its rounds) and nothing past cap is
// stored. No branches but the predicated store.
__device__ __forceinline__ void emit(Enc& e, int cap) {
  e.dead |= e.pos >= cap;
  e.acc = (e.acc >> 8) | (e.low & 0xFF000000u);
  ++e.pos;
  const bool word = (e.pos & 3) == 0;
  e.q0 = word ? e.q1 : e.q0;
  e.q1 = word ? e.q2 : e.q1;
  e.q2 = word ? e.q3 : e.q2;
  e.q3 = word ? e.acc : e.q3;
  if ((e.pos & 15) == 0 && !e.dead) {
    *reinterpret_cast<uint4*>(e.row + e.pos - 16) =
        make_uint4(e.q0, e.q1, e.q2, e.q3);
  }
}

// the symbol's interval: low += cf * range / 2^16, range = freq * range / 2^16
__device__ __forceinline__ void narrow(Enc& e, uint32_t x) {
  // both entries loaded whatever x is, then the implied 65536 selected
  constexpr uint32_t kLast = kBins - 1;
  const uint32_t lo = e.cdf[min(x, kLast) * kStreams];
  const uint32_t hi = e.cdf[min(x + 1, kLast) * kStreams];
  const uint32_t cf = x < kBins ? lo : 65536u;
  const uint32_t cfn = x + 1 < kBins ? hi : 65536u;
  e.range /= 65536u;
  e.low += cf * e.range;
  e.range *= (cfn - cf);
}

// The C++ coder's renormalization test (carry-less: clamp range at
// low-boundary crossings, where low and low + range share their top byte no
// more but the range fell below 2^16); false again, with no effect, once it
// has been false. No branches.
__device__ __forceinline__ bool more(Enc& e) {
  const bool top = (e.low ^ (e.low + e.range)) < kTop;
  const bool clamp = !top && e.range < kBot;
  e.range = clamp ? (-e.low & (kBot - 1)) : e.range;
  return !e.dead && (top || clamp);
}

__device__ __forceinline__ void shift_out(Enc& e, int cap) {
  emit(e, cap);
  e.low <<= 8;
  e.range <<= 8;
}

// both streams' renormalization rounds in one loop
__device__ __forceinline__ void renormalize(Enc& a, Enc& b, int cap) {
  bool ma = more(a), mb = more(b);
  while (ma || mb) {
    if (ma) shift_out(a, cap);
    if (mb) shift_out(b, cap);
    ma = more(a);
    mb = more(b);
  }
}

// the flush, then the bytes since the last 16-byte store; bytes of the row
// past the stream's length may be written (they are never read)
__device__ __forceinline__ void finish(Enc& e, int cap, int32_t* len) {
  for (int i = 0; i < 4 && !e.dead; ++i) {
    emit(e, cap);
    e.low <<= 8;
  }
  if (e.dead) {
    *len = -1;
    return;
  }
  const int words = (e.pos & 15) >> 2;
  for (int r = words; r < 4; ++r) {  // the oldest unstored word to q0
    e.q0 = e.q1;
    e.q1 = e.q2;
    e.q2 = e.q3;
  }
  uint32_t* w = reinterpret_cast<uint32_t*>(e.row + (e.pos & ~15));
  for (int i = 0; i < words; ++i) {
    w[i] = e.q0;
    e.q0 = e.q1;
    e.q1 = e.q2;
  }
  const int rest = e.pos & 3;
  if (rest) w[words] = e.acc >> (8 * (4 - rest));
  *len = e.pos;
}

__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t byte_of(const uint4& w, int k) {
  const uint32_t word = k < 4 ? w.x : k < 8 ? w.y : k < 12 ? w.z : w.w;
  return (word >> (8 * (k & 3))) & 0xFFu;
}

// Streams a and b of one thread (b == a when the block has no second stream
// for it); VEC: rows of a multiple of 16 symbols, 16-aligned.
template <bool VEC>
__device__ __forceinline__ void encode_pair(const uint8_t* __restrict__ sa,
                                            const uint8_t* __restrict__ sb,
                                            int n, int cap, Enc& a, Enc& b) {
  if (VEC) {
    const int chunks = n / 16;
    uint4 na = load16(sa), nb = load16(sb);
    for (int c = 0; c < chunks; ++c) {
      const uint4 wa = na, wb = nb;
      if (c + 1 < chunks) {
        na = load16(sa + 16 * (c + 1));
        nb = load16(sb + 16 * (c + 1));
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        narrow(a, byte_of(wa, k));
        narrow(b, byte_of(wb, k));
        renormalize(a, b, cap);
      }
    }
  } else {
    for (int t = 0; t < n; ++t) {
      narrow(a, __ldg(sa + t));
      narrow(b, __ldg(sb + t));
      renormalize(a, b, cap);
    }
  }
}

__device__ __forceinline__ Enc start(uint8_t* out, int64_t s, int stride,
                                     const uint16_t* column) {
  Enc e;
  e.low = 0;
  e.range = 0xFFFFFFFFu;
  e.pos = 0;
  e.acc = e.q0 = e.q1 = e.q2 = e.q3 = 0;
  e.dead = false;
  e.row = out + s * static_cast<int64_t>(stride);
  e.cdf = column;
  return e;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    range_encode_kernel(const uint8_t* __restrict__ symbols,
                        const uint16_t* __restrict__ cdf, int n_streams,
                        int n_symbols, uint8_t* __restrict__ out,
                        int out_stride, int cap, int32_t* __restrict__ lens) {
  __shared__ CdfSmem sm;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kStreams;
  const int rows = static_cast<int>(
      min(static_cast<int64_t>(kStreams), n_streams - first));
  load_cdf(cdf, first, rows, sm);
  const int ja = threadIdx.x;
  if (ja >= rows) return;
  const int jb = ja + kThreads < rows ? ja + kThreads : ja;
  Enc a = start(out, first + ja, out_stride, sm.table + ja);
  Enc b = start(out, first + jb, out_stride, sm.table + jb);
  const int64_t n = n_symbols;
  encode_pair<VEC>(symbols + (first + ja) * n,
                        symbols + (first + jb) * n, n_symbols, cap, a, b);
  finish(b, cap, lens + first + jb);
  if (jb != ja) finish(a, cap, lens + first + ja);
}

// One warp a stream: payload[offsets[s] + i] = out[s, i] for i < lens[s],
// the row read as aligned words.
constexpr int kCompactWarps = 8;

__global__ void __launch_bounds__(kCompactWarps * 32)
    range_compact_kernel(const uint8_t* __restrict__ out, int out_stride,
                         const int32_t* __restrict__ lens,
                         const int64_t* __restrict__ offsets, int n_streams,
                         uint8_t* __restrict__ payload) {
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kCompactWarps + threadIdx.x / 32;
  if (s >= n_streams) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* src = out + s * static_cast<int64_t>(out_stride);
  uint8_t* dst = payload + offsets[s];
  const int len = lens[s];
  for (int i = 4 * lane; i < len; i += 128) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(src + i));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k < len) dst[i + k] = static_cast<uint8_t>(w >> (8 * k));
    }
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns a cudaError_t (0 on success).
//
// symbols: uint8 [n_streams, n_symbols]; cdf: uint16 [n_streams, 33]; out:
// uint8 [n_streams, out_stride], 16-aligned with out_stride % 16 == 0; cap:
// the bytes a stream may take (the C++ coder's 2 * n_symbols + 16); lens:
// int32 [n_streams] (-1 on overflow).
extern "C" int lmc_range_encode(const uint8_t* symbols, const uint16_t* cdf,
                                int n_streams, int n_symbols, uint8_t* out,
                                int out_stride, int cap, int32_t* lens,
                                void* stream) {
  if (n_streams <= 0) return 0;
  if (out_stride % 16 || (reinterpret_cast<uintptr_t>(out) & 15) ||
      cap > out_stride) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (n_streams + kStreams - 1) / kStreams;
  if (n_symbols % 16 == 0 && (reinterpret_cast<uintptr_t>(symbols) & 15) == 0) {
    range_encode_kernel<true><<<blocks, kThreads, 0, st>>>(
        symbols, cdf, n_streams, n_symbols, out, out_stride, cap, lens);
  } else {
    range_encode_kernel<false><<<blocks, kThreads, 0, st>>>(
        symbols, cdf, n_streams, n_symbols, out, out_stride, cap, lens);
  }
  return static_cast<int>(cudaGetLastError());
}

// out, out_stride, lens as above (no -1 left); offsets: int64 [n_streams],
// the exclusive scan of lens; payload: uint8 [sum of lens].
extern "C" int lmc_range_compact(const uint8_t* out, int out_stride,
                                 const int32_t* lens, const int64_t* offsets,
                                 int n_streams, uint8_t* payload,
                                 void* stream) {
  if (n_streams <= 0) return 0;
  if (out_stride % 4 || (reinterpret_cast<uintptr_t>(out) & 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_streams + kCompactWarps - 1) / kCompactWarps;
  range_compact_kernel<<<blocks, kCompactWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      out, out_stride, lens, offsets, n_streams, payload);
  return static_cast<int>(cudaGetLastError());
}
