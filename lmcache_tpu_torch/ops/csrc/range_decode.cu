// Range decoder for CacheGen containers, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmcache_tpu/ops/range_decode.py::_decode_tile_kernel
// (entry point decode_streams_pallas, pallas_call at range_decode.py:426).
// It decodes S independent streams, each n symbols against its own 33-entry
// uint16 CDF, and is symbol-exact with codec/csrc/lmtc_codec.cc::decode_stream:
// each stream runs exactly that recurrence, reading its bytes from the
// concatenated payload through int64 offsets, with the coder's zero feed past
// its end, and an unbounded renormalization loop (so no overflow flag).
//
// Two entries share the body: one writes the symbols, uint8 [S, n]; the
// other writes the dequantized wire blob of the CacheGen serde
// (storage/serde/cachegen_serde.py::symbols_to_blob, bit-equal): each symbol
// s of a (chunk, half, layer, channel group) stream becomes
// (s - half[half, layer]) * maxes[chunk, half, layer, token] / half[...] in
// fp32 with IEEE rounding, stored as bfloat16, float16 or float32 at its
// (layer, half, token, head, dim) place of the vllm [L, N, T, H, D] or hf
// [L, N, H, T, D] layout, inside the token window [tok_start, tok_stop).
// At one channel a stream (full chunks) the lanes of a warp are adjacent
// channels, so each symbol step of a warp stores 64 contiguous bytes of bf16.
//
// Bound on an H100: per symbol a 32-bit division (nvcc's sequence), the
// symbol search and about 15 more integer operations: bound by integer
// operations, not by the bytes. What the design does about it:
// - two streams a thread (range_coder.cuh: lanes hold adjacent streams),
//   each step deciding both streams' symbols before either renormalizes,
//   and both renormalizing in one branch-free loop, so that the two serial
//   chains overlap;
// - the search in 5 steps (16, 8, 4, 2, 1) instead of 31 compares: the first
//   two from registers, three from the transposed CDF table in shared memory
//   (conflict-free); the table's count of entries <= target, which the C++
//   coder computes, equals it on rows whose entries 1..31 do not fall, and a
//   block that holds a row that falls (only a corrupt table, refused by the
//   container parser) takes the 31-compare count, so the symbols stay exact
//   on any table;
// - payload bytes through registers: each stream keeps 8 bytes in a shift
//   register and the next aligned 8-byte word already loaded, so a
//   renormalization round reads no memory and a load is issued 8 bytes
//   ahead of its use (loads past the payload's last word read that word);
// - the symbols written 4 at a time as a word where rows are 4-aligned.
// A range can collapse to 0 only under a CDF that does not rise strictly,
// where the C++ coder never returns: that stream decodes as zeros from there
// on, never a hung card.
//
// The TPU kernel's lane-packed words, one-hot gathers, f32 division ladder,
// fixed renormalization unroll and zero-padded [S, stride] payload have no
// counterpart.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "range_coder.cuh"

namespace {

using namespace lmc_range;

__device__ const uint64_t kZeroWord = 0;

__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  const uint32_t lo = static_cast<uint32_t>(x);
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  return (static_cast<uint64_t>(__byte_perm(lo, 0, 0x0123)) << 32) |
         __byte_perm(hi, 0, 0x0123);
}

// One stream's bytes, fed one at a time from registers.
struct Feed {
  uint64_t win;   // bytes not fed yet, the next one in the top byte
  uint64_t next;  // the aligned word after them, as loaded
  uint32_t w;     // index of the aligned word after `next`
  int nb;         // bytes left in win
  int left;       // stream bytes not fed yet (<= 0: the zero feed)
};

// The payload as aligned 8-byte words: word i is base[i]; loads of words
// past `last` (the word holding the payload's last byte) read `last`
// instead: those bytes lie past every stream's end and are never fed. A
// load's result is not needed until its word is fed, 8 bytes later.
struct Words {
  const uint64_t* base;
  uint32_t last;
  __device__ __forceinline__ uint64_t load(uint32_t i) const {
    return __ldg(base + min(i, last));
  }
};

__device__ __forceinline__ Feed feed_at(const Words& words, uint64_t at,
                                        int64_t len) {
  Feed f;
  const uint32_t i = static_cast<uint32_t>(at >> 3);
  const int skip = static_cast<int>(at & 7);
  f.win = bswap64(words.load(i)) << (8 * skip);
  f.nb = 8 - skip;
  f.next = words.load(i + 1);
  f.w = i + 2;
  // a stream never feeds 2^31 bytes: n symbols take at most a few each
  f.left = static_cast<int>(min(len, static_cast<int64_t>(INT32_MAX)));
  return f;
}

__device__ __forceinline__ uint32_t feed_byte(Feed& f, const Words& words) {
  const uint32_t b = f.left > 0 ? static_cast<uint32_t>(f.win >> 56) : 0u;
  --f.left;
  const bool refill = f.nb == 1;
  f.win = refill ? bswap64(f.next) : f.win << 8;
  f.nb = refill ? 8 : f.nb - 1;
  if (refill) f.next = words.load(f.w++);
  return b;
}

// One stream's decoder state.
struct Dec {
  uint32_t low, range, code;
  uint32_t c0, c8, c16, c24;  // CDF entries the search's first steps read
  bool dead;                  // the range collapsed: zeros from here on
  const uint16_t* cdf;        // its column of the shared CDF table
  Feed f;
};

// Entries 1..31 of stream j's CDF row never fall: the 5-step search then
// finds the C++ coder's count of entries <= target.
__device__ __forceinline__ bool rises(const CdfSmem& sm, int j) {
  const uint16_t* row = sm.raw + j * (kBins + 1);
  bool r = true;
  for (int x = 1; x + 1 < kBins; ++x) r &= row[x] <= row[x + 1];
  return r;
}

__device__ __forceinline__ Dec start(const CdfSmem& sm, int j,
                                     const Words& words, uint64_t skew,
                                     const int64_t* offsets, int64_t s) {
  Dec d;
  const uint16_t* row = sm.raw + j * (kBins + 1);
  d.c0 = row[0];
  d.c8 = row[8];
  d.c16 = row[16];
  d.c24 = row[24];
  d.cdf = sm.table + j;
  d.dead = false;
  d.low = 0;
  d.range = 0xFFFFFFFFu;
  d.code = 0;
  const int64_t o = offsets[s];
  d.f = feed_at(words, skew + o, offsets[s + 1] - o);
  for (int i = 0; i < 4; ++i) d.code = (d.code << 8) | feed_byte(d.f, words);
  return d;
}

// The next symbol's interval: its symbol (the count of CDF entries <=
// target), and low and range narrowed to it. Straight-line code on rising
// rows, so that a thread's two streams interleave.
template <bool RISES>
__device__ __forceinline__ uint32_t decide(Dec& d) {
  d.range /= 65536u;
  const uint32_t target = min((d.code - d.low) / max(d.range, 1u), 65535u);
  uint32_t lo, cf;
  if (RISES) {
    lo = d.c16 <= target ? 16u : 0u;
    cf = lo ? d.c16 : d.c0;
    uint32_t v = lo ? d.c24 : d.c8;
    if (v <= target) {
      lo += 8;
      cf = v;
    }
#pragma unroll
    for (uint32_t w = 4; w; w >>= 1) {
      v = d.cdf[(lo + w) * kStreams];
      if (v <= target) {
        lo += w;
        cf = v;
      }
    }
  } else {
    lo = 0;
    for (int i = 1; i < kBins; ++i) lo += d.cdf[i * kStreams] <= target;
    cf = d.cdf[lo * kStreams];
  }
  const uint32_t cfn = lo + 1 < kBins ? d.cdf[(lo + 1) * kStreams] : 65536u;
  d.low += cf * d.range;
  d.range *= (cfn - cf);
  return lo;
}

// The C++ coder's renormalization test, with its clamp of the range when
// low and low + range share their top byte no more but the range fell below
// 2^16; false again, with no effect, once it has been false. No branches.
__device__ __forceinline__ bool more(Dec& d) {
  const bool top = (d.low ^ (d.low + d.range)) < kTop;
  const bool clamp = !top && d.range < kBot;
  d.range = clamp ? (-d.low & (kBot - 1)) : d.range;
  return d.range != 0 && (top || clamp);
}

__device__ __forceinline__ void shift_in(Dec& d, const Words& words) {
  d.code = (d.code << 8) | feed_byte(d.f, words);
  d.low <<= 8;
  d.range <<= 8;
}

// ---------------------------------------------------------------- outputs ---

// Symbols: uint8 [S, n]. WORDS: rows 4-aligned, stored 4 symbols at a time.
template <bool WORDS>
struct SymbolsOut {
  uint8_t* out;
  int n;
  struct Stream {
    uint8_t* row;
    uint32_t acc;
  };
  __device__ __forceinline__ Stream open(int64_t s) const {
    return {out + s * static_cast<int64_t>(n), 0u};
  }
  __device__ __forceinline__ int groups() const { return 1; }
  __device__ __forceinline__ int tokens() const { return n; }
  __device__ __forceinline__ void group(Stream&, int) const {}
  __device__ __forceinline__ void put(Stream& o, int t, uint32_t sym) const {
    if (WORDS) {
      o.acc = (o.acc >> 8) | (sym << 24);
      if ((t & 3) == 3) *reinterpret_cast<uint32_t*>(o.row + t - 3) = o.acc;
    } else {
      o.row[t] = static_cast<uint8_t>(sym);
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ float from_float(float v) {
  return v;
}

// Where the fused entry writes: stream s of the launch is (chunk, half,
// layer, channel group) in that order; its symbol k * T + t is channel
// group * g + k of token chunk * T + t.
struct BlobGeometry {
  int N, L, H, D, T, g, Cg;
  int tok_start, tok_stop;
  int64_t sL, sN, sT, sH;  // output strides (elements) of layer, half,
                           // token, head; a dim's is 1
};

template <typename T>
struct BlobOut {
  T* out;
  const float* maxes;  // f32 [chunks, N, L, T]
  const float* half;   // f32 [N, L]
  BlobGeometry geo;
  struct Stream {
    T* dst;             // element of token 0 of the current channel
    const float* maxes; // the stream's [T] maxes
    float h, hb;        // half, and 2^23 + half
    int t_lo, t_n;      // tokens [t_lo, t_lo + t_n) of the chunk are kept
    int64_t plane_off;  // the (layer, half) plane's offset less the window's
    int c0;             // the group's first channel
  };
  __device__ __forceinline__ Stream open(int64_t s) const {
    Stream o;
    const int64_t plane = s / geo.Cg;
    o.c0 = static_cast<int>(s - plane * geo.Cg) * geo.g;
    const int64_t chunk = plane / (geo.N * geo.L);
    const int n = static_cast<int>((plane / geo.L) % geo.N);
    const int l = static_cast<int>(plane % geo.L);
    o.maxes = maxes + plane * geo.T;
    o.h = half[n * geo.L + l];
    o.hb = 8388608.0f + o.h;
    const int64_t tok0 = chunk * geo.T - geo.tok_start;  // token 0's place
    const int64_t lo = max(int64_t{0}, -tok0);
    const int64_t hi = min(static_cast<int64_t>(geo.T),
                           static_cast<int64_t>(geo.tok_stop - geo.tok_start) -
                               tok0);
    o.t_lo = static_cast<int>(lo);
    o.t_n = static_cast<int>(max(int64_t{0}, hi - lo));
    o.plane_off = l * geo.sL + n * geo.sN + tok0 * geo.sT;
    return o;
  }
  __device__ __forceinline__ int groups() const { return geo.g; }
  __device__ __forceinline__ int tokens() const { return geo.T; }
  __device__ __forceinline__ void group(Stream& o, int k) const {
    const int c = o.c0 + k;
    const int hd = c / geo.D;
    o.dst = out + o.plane_off + hd * geo.sH + (c - hd * geo.D);
  }
  __device__ __forceinline__ void put(Stream& o, int t, uint32_t sym) const {
    // (s - half) * max / half in fp32, as symbols_to_blob: 2^23 + s less
    // 2^23 + half is s - half exactly. The maxes of a chunk's tokens are
    // read past the window too (they exist); only the store is windowed.
    const float x = __fsub_rn(__uint_as_float(0x4B000000u | sym), o.hb);
    const float v = __fdiv_rn(__fmul_rn(x, __ldg(o.maxes + t)), o.h);
    if (static_cast<unsigned>(t - o.t_lo) < static_cast<unsigned>(o.t_n)) {
      o.dst[t * geo.sT] = from_float<T>(v);
    }
  }
};

template <bool RISES, class Out>
__device__ __forceinline__ void decode_pair(Dec& a, Dec& b, const Out& out,
                                            typename Out::Stream& oa,
                                            typename Out::Stream& ob,
                                            const Words& words) {
  const int T = out.tokens();
  for (int k = 0; k < out.groups(); ++k) {
    out.group(oa, k);
    out.group(ob, k);
    for (int t = 0; t < T; ++t) {
      const uint32_t la = decide<RISES>(a);
      const uint32_t lb = decide<RISES>(b);
      // both streams' renormalization rounds in one loop
      bool ma = more(a), mb = more(b);
      while (ma || mb) {
        if (ma) shift_in(a, words);
        if (mb) shift_in(b, words);
        ma = more(a);
        mb = more(b);
      }
      // only a corrupt CDF (a decoded zero-width bin) collapses the range,
      // and there the C++ coder never returns: the stream decodes as zeros
      out.put(oa, t, a.dead ? 0u : la);
      out.put(ob, t, b.dead ? 0u : lb);
      a.dead |= a.range == 0;
      b.dead |= b.range == 0;
    }
  }
}

template <class Out>
__global__ void __launch_bounds__(kThreads)
    range_decode_kernel(const uint8_t* __restrict__ payload,
                        const int64_t* __restrict__ offsets,
                        const uint16_t* __restrict__ cdf, int n_streams,
                        const Out out) {
  __shared__ CdfSmem sm;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kStreams;
  const int rows = static_cast<int>(
      min(static_cast<int64_t>(kStreams), n_streams - first));
  load_cdf(cdf, first, rows, sm);
  const int ja = threadIdx.x;
  const int jb = ja + kThreads < rows ? ja + kThreads : ja;
  // one search for the whole block: the 5-step one unless a row falls
  const bool all_rise =
      __syncthreads_and(ja >= rows || (rises(sm, ja) && rises(sm, jb)));
  if (ja >= rows) return;
  // the payload as aligned words from the one that holds its first byte
  // (a zero word for an empty payload)
  const int64_t total = offsets[n_streams];
  const uint64_t skew = reinterpret_cast<uintptr_t>(payload) & 7;
  const Words words =
      total > 0 ? Words{reinterpret_cast<const uint64_t*>(payload - skew),
                        static_cast<uint32_t>((skew + total - 1) >> 3)}
                : Words{&kZeroWord, 0};
  Dec a = start(sm, ja, words, skew, offsets, first + ja);
  Dec b = start(sm, jb, words, skew, offsets, first + jb);
  typename Out::Stream oa = out.open(first + ja);
  typename Out::Stream ob = out.open(first + jb);
  if (all_rise) {
    decode_pair<true>(a, b, out, oa, ob, words);
  } else {
    decode_pair<false>(a, b, out, oa, ob, words);
  }
}

template <class Out>
int launch(const uint8_t* payload, const int64_t* offsets,
           const uint16_t* cdf, int n_streams, const Out& out, void* stream) {
  const int blocks = (n_streams + kStreams - 1) / kStreams;
  range_decode_kernel<Out><<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      payload, offsets, cdf, n_streams, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns a cudaError_t (0 on success). payload: the concatenated streams;
// offsets: int64 [n_streams + 1]; cdf: uint16 [n_streams, 33].

// out: uint8 [n_streams, n_symbols].
extern "C" int lmc_range_decode(const uint8_t* payload, const int64_t* offsets,
                                const uint16_t* cdf, int n_streams,
                                int n_symbols, uint8_t* out, void* stream) {
  if (n_streams <= 0 || n_symbols <= 0) return 0;
  if (n_symbols % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0) {
    return launch(payload, offsets, cdf, n_streams,
                  SymbolsOut<true>{out, n_symbols}, stream);
  }
  return launch(payload, offsets, cdf, n_streams,
                SymbolsOut<false>{out, n_symbols}, stream);
}

// The fused entry: streams of `chunks` chunks in (chunk, half, layer,
// group) order, each g * T symbols; maxes: f32 [chunks, N, L, T]; half: f32
// [N, L]; out: the blob, dtype 0 bfloat16, 1 float16, 2 float32, with the
// strides sL, sN, sT, sH (elements) of its layer, half, token and head axes
// (its dim's is 1), holding tokens [tok_start, tok_stop) of the run.
extern "C" int lmc_range_decode_blob(
    const uint8_t* payload, const int64_t* offsets, const uint16_t* cdf,
    int n_streams, const float* maxes, const float* half, int N, int L, int H,
    int D, int T, int g, int tok_start, int tok_stop, int64_t sL, int64_t sN,
    int64_t sT, int64_t sH, void* out, int dtype, void* stream) {
  if (n_streams <= 0) return 0;
  if (g <= 0 || T <= 0 || (H * D) % g || n_streams % (N * L * (H * D / g))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BlobGeometry geo{N, L, H, D, T, g, H * D / g, tok_start, tok_stop,
                         sL, sN, sT, sH};
  switch (dtype) {
    case 0:
      return launch(payload, offsets, cdf, n_streams,
                    BlobOut<__nv_bfloat16>{static_cast<__nv_bfloat16*>(out),
                                           maxes, half, geo},
                    stream);
    case 1:
      return launch(payload, offsets, cdf, n_streams,
                    BlobOut<__half>{static_cast<__half*>(out), maxes, half,
                                    geo},
                    stream);
    case 2:
      return launch(payload, offsets, cdf, n_streams,
                    BlobOut<float>{static_cast<float*>(out), maxes, half,
                                   geo},
                    stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
