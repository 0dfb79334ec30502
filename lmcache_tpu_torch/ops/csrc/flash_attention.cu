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
// - at most 16 rows (every decode step of the dense engines): a key-split
//   decode. One block takes one (sequence, KV head, split of SPLIT keys)
//   and writes a partial (m, l, O[rows, D]) in fp32 to scratch the wrapper
//   allocates; a second kernel combines the partials of a row in a fixed
//   order and joins the sinks once. Bound by the K/V bytes (~G * 4
//   operations a byte): one block a (sequence, KV head) walking all its
//   keys, as the TPU kernel's program does, would leave B * H_kv blocks on
//   132 SMs; the split puts B * H_kv * S / SPLIT blocks on them. The grid is sized from S on the host (a host read of kv_len
//   would add a sync); a split past a row's keys writes an empty partial
//   (m = -1e30, l = 0) that the combine skips. Split points are absolute
//   multiples of SPLIT, so a row's result depends on its own keys only,
//   never on B or on its batch-mates, and no float atomics are used: two
//   launches give the same bits.

#include "flash_sm90.cuh"

namespace lmc {
namespace split {

constexpr int SPLIT = 256;     // keys a split
constexpr int MAX_ROWS = 16;   // rows T * G that the split decode takes
constexpr int THREADS = 128;
constexpr int PT_LD = 17;      // fp32 pitch of P^T rows (no conflicts)

template <int D>
struct Geometry {
  static constexpr int CH = 64;  // keys a chunk
  static constexpr int LD = D + 8;  // bf16 pitch of K/V rows (no conflicts)
  static constexpr int CHUNK = CH * LD * 2;  // one K or V chunk (bytes)
  static constexpr int Q_OFF = 2 * 2 * CHUNK;  // two stages of K and V
  static constexpr int S_OFF = Q_OFF + MAX_ROWS * D * 4;  // fp32 Q
  static constexpr int P_OFF = S_OFF + MAX_ROWS * CH * 4;  // scores
  static constexpr int M_OFF = P_OFF + CH * PT_LD * 4;     // P^T
  static constexpr int BYTES = M_OFF + 3 * MAX_ROWS * 4;   // m, l, alpha
};

// One (sequence, KV head, split): the partial of every row over the live
// keys of the split, unnormalized, in fp32.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS)
    decode_split_fwd(const FlashArgs a, float* part_o, float* part_ml,
                     int nsplit) {
  using Gm = Geometry<D>;
  constexpr int CH = Gm::CH, LD = Gm::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + Gm::Q_OFF);
  float* Ss = reinterpret_cast<float*>(smem + Gm::S_OFF);
  float* Pt = reinterpret_cast<float*>(smem + Gm::P_OFF);
  float* ms = reinterpret_cast<float*>(smem + Gm::M_OFF);
  float* ls = ms + MAX_ROWS;
  float* as = ls + MAX_ROWS;
  auto k_chunk = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * 2 * Gm::CHUNK);
  };
  auto v_chunk = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * 2 * Gm::CHUNK + Gm::CHUNK);
  };

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, sp = blockIdx.x;
  const int R = a.T * a.G;
  const int qoff = a.q_offset[b];
  const int klen = min(a.kv_len[b], a.S);
  // the keys some row sees, cut to this split
  const int lo = max(sp * SPLIT, window_start(a, qoff));
  const int hi = min(sp * SPLIT + SPLIT - 1, min(qoff + a.T - 1, klen - 1));
  const long long row0 =
      (static_cast<long long>(b * gridDim.y + h) * nsplit + sp) * R;
  if (lo > hi) {  // an empty partial
    for (int r = tid; r < R; r += THREADS) {
      part_ml[2 * (row0 + r)] = NEG_INF;
      part_ml[2 * (row0 + r) + 1] = 0.f;
    }
    return;
  }
  const long long bkv = a.kv_slot != nullptr ? a.kv_slot[0] : b;
  const bf16* kbase = static_cast<const bf16*>(a.k) + bkv * a.kb + h * a.kh;
  const bf16* vbase = static_cast<const bf16*>(a.v) + bkv * a.vb + h * a.vh;

  // keys [c0, c0 + CH) into stage st, zero outside [lo, hi]
  auto request = [&](int c0, int st) {
    bf16* kd = k_chunk(st);
    bf16* vd = v_chunk(st);
    for (int i = tid; i < CH * (D / 8); i += THREADS) {
      const int row = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      const int kpos = c0 + row;
      if (kpos >= lo && kpos <= hi) {
        load_async(kd + row * LD + c, kbase + kpos * a.ks + c);
        load_async(vd + row * LD + c, vbase + kpos * a.vs + c);
      } else {
        store_zero<8>(kd + row * LD + c);
        store_zero<8>(vd + row * LD + c);
      }
    }
    async_commit();
  };

  const int first = lo / CH * CH;
  const int chunks = (hi - first) / CH + 1;
  request(first, 0);
  const bf16* qbase = static_cast<const bf16*>(a.q) + b * a.qb +
                      static_cast<long long>(h) * a.G * a.qh;
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qs[i] = __bfloat162float(qbase[(r / a.G) * a.qt + (r % a.G) * a.qh + d]);
  }
  if (tid < MAX_ROWS) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
    as[tid] = 0.f;
  }

  // scores: a thread takes a key and RPT rows
  constexpr int GROUPS = THREADS / CH;
  constexpr int RPT = MAX_ROWS / GROUPS;
  // P V: a thread takes a column pair and the rows rg, rg + NG, ...
  constexpr int NDP = D / 2;
  constexpr int NG = THREADS / NDP;
  constexpr int RPG = (MAX_ROWS + NG - 1) / NG;
  const int dp = tid % NDP, rg = tid / NDP;
  const bool pv_live = rg < NG && rg < R;
  float o[RPG][2];
#pragma unroll
  for (int i = 0; i < RPG; ++i) o[i][0] = o[i][1] = 0.f;

  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = first + ci * CH;
    const int st = ci & 1;
    if (ci + 1 < chunks) {
      request(c0 + CH, st ^ 1);
    } else {
      async_commit();  // keeps the count of groups in step
    }
    async_wait<1>();
    __syncthreads();

    {
      const int j = tid % CH, grp = tid / CH;
      const bf16* krow = k_chunk(st) + j * LD;
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
#pragma unroll 2
      for (int c = 0; c < D; c += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
        const __nv_bfloat162* k2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(k2[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = grp + GROUPS * i;
          if (r < R) {
            const float4 q0 = *reinterpret_cast<const float4*>(Qs + r * D + c);
            const float4 q1 =
                *reinterpret_cast<const float4*>(Qs + r * D + c + 4);
            float x = acc[i];
            x = fmaf(q0.x, kf[0], x);
            x = fmaf(q0.y, kf[1], x);
            x = fmaf(q0.z, kf[2], x);
            x = fmaf(q0.w, kf[3], x);
            x = fmaf(q1.x, kf[4], x);
            x = fmaf(q1.y, kf[5], x);
            x = fmaf(q1.z, kf[6], x);
            x = fmaf(q1.w, kf[7], x);
            acc[i] = x;
          }
        }
      }
      const int kpos = c0 + j;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = grp + GROUPS * i;
        if (r < R) {
          const int qpos = qoff + r / a.G;
          float x = acc[i] * a.scale;
          if (SOFTCAP) x = a.softcap * tanhf(x / a.softcap);
          const bool live = kpos <= min(qpos, klen - 1) &&
                            kpos > window_floor(a, qpos);
          Ss[r * CH + j] = live ? x : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 4, ...
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int r = warp; r < R; r += THREADS / 32) {
        float x[CH / 32];
        float mx = NEG_INF;
#pragma unroll
        for (int u = 0; u < CH / 32; ++u) {
          x[u] = Ss[r * CH + lane + 32 * u];
          mx = fmaxf(mx, x[u]);
        }
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        }
        const float m_old = ms[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < CH / 32; ++u) {
          const float p = x[u] > 0.5f * NEG_INF ? expf(x[u] - m_new) : 0.f;
          Pt[(lane + 32 * u) * PT_LD + r] = p;
          sum += p;
        }
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, sh);
        }
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          ms[r] = m_new;
          ls[r] = alpha * ls[r] + sum;
          as[r] = alpha;
        }
      }
    }
    __syncthreads();

    if (pv_live) {
      const bf16* vcol = v_chunk(st) + 2 * dp;
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        if (rg + NG * i < R) {
          const float alpha = as[rg + NG * i];
          o[i][0] *= alpha;
          o[i][1] *= alpha;
        }
      }
#pragma unroll 4
      for (int j = 0; j < CH; ++j) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vcol + j * LD));
        const float* prow = Pt + j * PT_LD + rg;
#pragma unroll
        for (int i = 0; i < RPG; ++i) {
          if (rg + NG * i < R) {
            const float p = prow[NG * i];
            o[i][0] = fmaf(p, v.x, o[i][0]);
            o[i][1] = fmaf(p, v.y, o[i][1]);
          }
        }
      }
    }
    __syncthreads();  // the stage and P are free for the next chunk
  }
  async_wait<0>();

  if (pv_live) {
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int r = rg + NG * i;
      if (r < R) {
        *reinterpret_cast<float2*>(part_o + (row0 + r) * D + 2 * dp) =
            make_float2(o[i][0], o[i][1]);
      }
    }
  }
  for (int r = tid; r < R; r += THREADS) {
    part_ml[2 * (row0 + r)] = ms[r];
    part_ml[2 * (row0 + r) + 1] = ls[r];
  }
}

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

template <int D, bool SOFTCAP>
cudaError_t launch_split(const FlashArgs& a, int B, int Hkv, float* part_o,
                         float* part_ml, int nsplit, cudaStream_t stream) {
  constexpr int bytes = Geometry<D>::BYTES;
  static_assert(bytes <= SMEM_LIMIT, "the split does not fit");
  static std::atomic<int> raised[64];
  cudaError_t err =
      raise_smem_limit(decode_split_fwd<D, SOFTCAP>, bytes, raised);
  if (err != cudaSuccess) return err;
  decode_split_fwd<D, SOFTCAP><<<dim3(nsplit, Hkv, B), THREADS, bytes,
                                 stream>>>(a, part_o, part_ml, nsplit);
  return cudaGetLastError();
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

// Keys a split of the decode path (the wrapper sizes its scratch with it).
extern "C" int lmc_flash_split_keys() { return lmc::split::SPLIT; }

// The split decode's first kernel: partials of T * G <= 16 rows into
// part_o [B, H_kv, nsplit, T * G, D] and part_ml [.., 2] (m, l), fp32, with
// nsplit = max(1, ceil(S / SPLIT)).
extern "C" int lmc_flash_decode_split_bf16(const lmc::FlashArgs* a, int B,
                                           int H, int Hkv, int D,
                                           void* part_o, void* part_ml,
                                           int nsplit, void* stream) {
  using lmc::split::launch_split;
  using lmc::split::SPLIT;
  if (lmc::flash_bad_sizes(a, B, H, Hkv) ||
      a->T * a->G > lmc::split::MAX_ROWS ||
      nsplit != (a->S + SPLIT - 1) / SPLIT + (a->S == 0)) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto* po = static_cast<float*>(part_o);
  auto* pm = static_cast<float*>(part_ml);
  const bool cap = a->softcap > 0.f;
  switch (D) {
    case 64:
      return cap ? launch_split<64, true>(*a, B, Hkv, po, pm, nsplit, s)
                 : launch_split<64, false>(*a, B, Hkv, po, pm, nsplit, s);
    case 96:
      return cap ? launch_split<96, true>(*a, B, Hkv, po, pm, nsplit, s)
                 : launch_split<96, false>(*a, B, Hkv, po, pm, nsplit, s);
    case 128:
      return cap ? launch_split<128, true>(*a, B, Hkv, po, pm, nsplit, s)
                 : launch_split<128, false>(*a, B, Hkv, po, pm, nsplit, s);
    case 256:
      return cap ? launch_split<256, true>(*a, B, Hkv, po, pm, nsplit, s)
                 : launch_split<256, false>(*a, B, Hkv, po, pm, nsplit, s);
    default:
      return cudaErrorInvalidValue;
  }
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
