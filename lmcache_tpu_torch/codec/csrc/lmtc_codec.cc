// Parallel range coder for CacheGen-style KV bitstreams.
//
// TPU-native replacement for the reference's CUDA entropy codec
// (torchac_cuda: encode_fast_new / decode_fast_prefsum, used at
// reference lmcache/serde/cachegen_encoder.py:255 and
// cachegen_decoder.py:52-66). Bit-serial arithmetic coding does not map
// onto the TPU vector units, so — as on GPU — parallelism comes from
// thousands of independent (layer, channel) streams, here spread across
// host cores with OpenMP while the TPU runs quantization and attention.
//
// Coder: carry-less byte-oriented range coder (Subbotin style) with
// 16-bit cumulative frequencies. CDFs are uint16 with cdf[0] == 0 and an
// implied final bound of 65536 (the Python side guarantees strict
// monotonicity via the +arange normalization trick).
//
// Build: g++ -O3 -fopenmp -shared -fPIC (see lmcache_tpu/codec/build.py).

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr uint32_t kBot = 1u << 16;

inline uint32_t cdf_at(const uint16_t* cdf, int n_bins, int i) {
  // implied upper bound: cdf[n_bins] == 65536 (wraps to 0 in uint16)
  if (i >= n_bins) return 65536u;
  return cdf[i];
}

// Encode one stream of n symbols. Returns the number of bytes written.
int encode_stream(const uint8_t* symbols, int n, const uint16_t* cdf,
                  int n_bins, uint8_t* out, int out_cap) {
  uint32_t low = 0, range = 0xFFFFFFFFu;
  int pos = 0;
  for (int t = 0; t < n; ++t) {
    const int s = symbols[t];
    const uint32_t cf = cdf_at(cdf, n_bins, s);
    const uint32_t cfn = cdf_at(cdf, n_bins, s + 1);
    range /= 65536u;
    low += cf * range;
    range *= (cfn - cf);
    // renormalize (carry-less: clamp range at low-boundary crossings)
    while ((low ^ (low + range)) < kTop ||
           (range < kBot && ((range = -low & (kBot - 1)), true))) {
      if (pos >= out_cap) return -1;
      out[pos++] = static_cast<uint8_t>(low >> 24);
      low <<= 8;
      range <<= 8;
    }
  }
  for (int i = 0; i < 4; ++i) {
    if (pos >= out_cap) return -1;
    out[pos++] = static_cast<uint8_t>(low >> 24);
    low <<= 8;
  }
  return pos;
}

// Branchless symbol search: the count of CDF entries <= target IS the
// symbol (cdf[0] == 0 <= target always). For the CacheGen alphabets
// (n_bins <= 32) the loop auto-vectorizes under -O3 into a handful of
// packed uint16 compares — measured ~1.4x over a binary search, whose
// ~5 data-dependent branches mispredict on near-uniform streams. The
// linear scan stops paying past ~64 bins, so large alphabets (the entry
// points accept arbitrary n_bins) fall back to binary search.
inline int find_symbol(const uint16_t* cdf, int n_bins, uint32_t target) {
  if (n_bins > 64) {
    int lo = 0, hi = n_bins;  // invariant: cdf[lo] <= target < cdf[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= target) lo = mid; else hi = mid;
    }
    return lo;
  }
  int lo = 0;
  for (int i = 1; i < n_bins; ++i) lo += (cdf[i] <= target) ? 1 : 0;
  return lo;
}

// Decode one stream of n symbols from `in` (len bytes).
void decode_stream(const uint8_t* in, int len, int n, const uint16_t* cdf,
                   int n_bins, uint8_t* out) {
  uint32_t low = 0, range = 0xFFFFFFFFu, code = 0;
  int pos = 0;
  for (int i = 0; i < 4; ++i)
    code = (code << 8) | (pos < len ? in[pos++] : 0);
  for (int t = 0; t < n; ++t) {
    range /= 65536u;
    uint32_t target = (code - low) / range;
    if (target > 65535u) target = 65535u;
    const int lo = find_symbol(cdf, n_bins, target);
    out[t] = static_cast<uint8_t>(lo);
    const uint32_t cf = cdf_at(cdf, n_bins, lo);
    const uint32_t cfn = cdf_at(cdf, n_bins, lo + 1);
    low += cf * range;
    range *= (cfn - cf);
    while ((low ^ (low + range)) < kTop ||
           (range < kBot && ((range = -low & (kBot - 1)), true))) {
      code = (code << 8) | (pos < len ? in[pos++] : 0);
      low <<= 8;
      range <<= 8;
    }
  }
}

// Decode kLanes streams in lockstep in one loop. The per-symbol 32-bit
// division dominates single-stream decode (~22-cycle latency on a
// chain the next symbol depends on); interleaving independent streams
// lets the divider pipeline them, like interleaved-rANS. Bit-exact:
// each lane runs exactly decode_stream's recurrence.
constexpr int kLanes = 4;

void decode_stream_xN(const uint8_t* const* in, const int* len, int n,
                      const uint16_t* const* cdf, int n_bins,
                      uint8_t* const* out) {
  uint32_t low[kLanes], range[kLanes], code[kLanes];
  int pos[kLanes];
  for (int k = 0; k < kLanes; ++k) {
    low[k] = 0;
    range[k] = 0xFFFFFFFFu;
    code[k] = 0;
    pos[k] = 0;
    for (int i = 0; i < 4; ++i)
      code[k] = (code[k] << 8) | (pos[k] < len[k] ? in[k][pos[k]++] : 0);
  }
  for (int t = 0; t < n; ++t) {
    uint32_t target[kLanes];
    // independent divisions first so they overlap in the divider
    for (int k = 0; k < kLanes; ++k) {
      range[k] /= 65536u;
      uint32_t tg = (code[k] - low[k]) / range[k];
      target[k] = tg > 65535u ? 65535u : tg;
    }
    for (int k = 0; k < kLanes; ++k) {
      const int lo = find_symbol(cdf[k], n_bins, target[k]);
      out[k][t] = static_cast<uint8_t>(lo);
      const uint32_t cf = cdf_at(cdf[k], n_bins, lo);
      const uint32_t cfn = cdf_at(cdf[k], n_bins, lo + 1);
      low[k] += cf * range[k];
      range[k] *= (cfn - cf);
      while ((low[k] ^ (low[k] + range[k])) < kTop ||
             (range[k] < kBot &&
              ((range[k] = -low[k] & (kBot - 1)), true))) {
        code[k] = (code[k] << 8) | (pos[k] < len[k] ? in[k][pos[k]++] : 0);
        low[k] <<= 8;
        range[k] <<= 8;
      }
    }
  }
}

}  // namespace

extern "C" {

// symbols: [n_streams, n_symbols] row-major.
// cdf:     [n_streams, n_bins + 1] uint16 (entry n_bins ignored/implied).
// out:     [n_streams, out_stride] byte buffer.
// out_lens:[n_streams] written byte counts (-1 on overflow).
void lmtc_encode_streams(const uint8_t* symbols, int n_streams, int n_symbols,
                         const uint16_t* cdf, int n_bins, uint8_t* out,
                         int out_stride, int32_t* out_lens) {
#pragma omp parallel for schedule(dynamic, 8)
  for (int i = 0; i < n_streams; ++i) {
    out_lens[i] = encode_stream(symbols + static_cast<int64_t>(i) * n_symbols,
                                n_symbols, cdf + static_cast<int64_t>(i) * (n_bins + 1),
                                n_bins, out + static_cast<int64_t>(i) * out_stride,
                                out_stride);
  }
}

// in:       concatenated bytestreams.
// offsets:  [n_streams + 1] byte offsets of each stream within `in`.
// out:      [n_streams, n_symbols] decoded symbols.
void lmtc_decode_streams(const uint8_t* in, const int64_t* offsets,
                         int n_streams, int n_symbols, const uint16_t* cdf,
                         int n_bins, uint8_t* out) {
  const int groups = n_streams / kLanes;
#pragma omp parallel for schedule(dynamic, 2)
  for (int gi = 0; gi < groups; ++gi) {
    const uint8_t* inp[kLanes];
    int len[kLanes];
    const uint16_t* cd[kLanes];
    uint8_t* op[kLanes];
    for (int k = 0; k < kLanes; ++k) {
      const int i = gi * kLanes + k;
      inp[k] = in + offsets[i];
      len[k] = static_cast<int>(offsets[i + 1] - offsets[i]);
      cd[k] = cdf + static_cast<int64_t>(i) * (n_bins + 1);
      op[k] = out + static_cast<int64_t>(i) * n_symbols;
    }
    decode_stream_xN(inp, len, n_symbols, cd, n_bins, op);
  }
  for (int i = groups * kLanes; i < n_streams; ++i) {
    decode_stream(in + offsets[i], static_cast<int>(offsets[i + 1] - offsets[i]),
                  n_symbols, cdf + static_cast<int64_t>(i) * (n_bins + 1), n_bins,
                  out + static_cast<int64_t>(i) * n_symbols);
  }
}

// Re-lay concatenated variable-length streams into a zero-padded
// [n_streams, stride] matrix — the transfer layout of the on-device
// range decoder (lmcache_tpu/ops/range_decode.py). A Python-side loop
// over ~1e5 streams costs seconds; this is one OpenMP memcpy pass.
void lmtc_pad_streams(const uint8_t* in, const int64_t* offsets,
                      int n_streams, int stride, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n_streams; ++i) {
    const int64_t len = offsets[i + 1] - offsets[i];
    const int64_t n = len < stride ? len : stride;
    uint8_t* dst = out + static_cast<int64_t>(i) * stride;
    std::memcpy(dst, in + offsets[i], n);
    std::memset(dst + n, 0, stride - n);
  }
}

int lmtc_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
