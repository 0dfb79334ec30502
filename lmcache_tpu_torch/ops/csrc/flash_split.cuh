// The key-split decode of the dense kernels (flash_attention.cu over bf16
// K/V, quantized_flash_attention.cu over int8 K/V) and of the paged ones
// (paged_attention.cu, paged_stream_attention.cu, bf16 or int8 arenas): the
// first of its two kernels, for launches of at most MAX_ROWS rows T * G
// (every decode step).
//
// One block takes one (sequence, KV head, split of SPLIT keys) and writes
// a partial (m, l, O[rows, D]) in fp32 to scratch the wrapper allocates;
// flash_attention.cu's combine kernel then merges the partials of a row in
// a fixed order and joins the sinks once. K/V chunks of CH keys come
// through a double buffer of cp.async copies; the products run on the CUDA
// cores in fp32 (16 rows at most: a tensor-core tile would be mostly
// padding). Split points are absolute multiples of SPLIT, so a row's
// result depends on its own keys only, never on B or on its batch-mates,
// and no float atomics are used: two launches give the same bits. A split
// past a row's keys writes an empty partial (m = -1e30, l = 0) that the
// combine skips. The grid is sized from S on the host (a host read of
// kv_len would add a sync).
//
// int8 K/V (KV = i8): the chunks are copied as int8 with the chunk's K and
// V scales beside them (0 outside the split's live keys); the symbols are
// converted to fp32 as they are read (exact), the K scale multiplies each
// score (times the score scale) before softcap and mask, and the V scale
// multiplies P after the row sum, as the TPU kernel does.
//
// Paged arena (PAGED): each key's row is found through the page table as
// it is copied (row kpos % page of page page_table[b, kpos / page]), and
// over int8 its scales likewise (entry kpos % page of the scale pools' row
// page_table[b, kpos / page]); keys outside the split's live range are not
// read, and a page id outside the pool (< 0 or >= P) reads as zero rows
// with scale 0, as the TMA fill of the paged prefill body does. The grid is
// sized from S = NP * page.

#pragma once

#include <type_traits>

#include "flash_args.cuh"

namespace lmc {
namespace split {

constexpr int SPLIT = 256;     // keys a split
constexpr int MAX_ROWS = 16;   // rows T * G that the split decode takes
constexpr int THREADS = 128;
constexpr int PT_LD = 17;      // fp32 pitch of P^T rows (no conflicts)

template <int D, typename KV>
struct Geometry {
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int CH = 64;  // keys a chunk
  // pitch of K/V rows in elements, no bank conflicts in the score loop's
  // reads (bf16: 16 bytes a read; int8: 16 symbols a read)
  static constexpr int LD = QUANT ? D + 16 : D + 8;
  static constexpr int CHUNK = CH * LD * sizeof(KV);  // one K or V chunk
  static constexpr int Q_OFF = 2 * 2 * CHUNK;  // two stages of K and V
  static constexpr int S_OFF = Q_OFF + MAX_ROWS * D * 4;  // fp32 Q
  static constexpr int P_OFF = S_OFF + MAX_ROWS * CH * 4;  // scores
  static constexpr int M_OFF = P_OFF + CH * PT_LD * 4;     // P^T
  static constexpr int SC_OFF = M_OFF + 3 * MAX_ROWS * 4;  // m, l, alpha
  // int8: the K and V scales of two stages
  static constexpr int BYTES = SC_OFF + (QUANT ? 2 * 2 * CH * 4 : 0);
};

// 16 bytes from device memory into shared memory, asynchronously
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}

// one fp32 likewise (a scale: its row need not be 16-byte aligned)
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4 symbols -> fp32, exactly
__device__ __forceinline__ void i8_to_float(const uint32_t w, float* f) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    f[b] = static_cast<float>(static_cast<signed char>(w >> (8 * b)));
  }
}

// One (sequence, KV head, split): the partial of every row over the live
// keys of the split, unnormalized, in fp32.
template <int D, bool SOFTCAP, typename KV, bool PAGED = false>
__global__ void __launch_bounds__(THREADS)
    decode_split_fwd(const FlashArgs a, float* part_o, float* part_ml,
                     int nsplit) {
  using Gm = Geometry<D, KV>;
  constexpr bool QUANT = Gm::QUANT;
  constexpr int CH = Gm::CH, LD = Gm::LD;
  constexpr int VEC = 16 / sizeof(KV);  // elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + Gm::Q_OFF);
  float* Ss = reinterpret_cast<float*>(smem + Gm::S_OFF);
  float* Pt = reinterpret_cast<float*>(smem + Gm::P_OFF);
  float* ms = reinterpret_cast<float*>(smem + Gm::M_OFF);
  float* ls = ms + MAX_ROWS;
  float* as = ls + MAX_ROWS;
  auto k_chunk = [&](int st) {
    return reinterpret_cast<KV*>(smem + st * 2 * Gm::CHUNK);
  };
  auto v_chunk = [&](int st) {
    return reinterpret_cast<KV*>(smem + st * 2 * Gm::CHUNK + Gm::CHUNK);
  };
  // int8: [stage][K, V][CH] scales
  auto scales = [&](int st) {
    return reinterpret_cast<float*>(smem + Gm::SC_OFF) + st * 2 * CH;
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
  const long long bkv = PAGED ? 0 : a.kv_slot != nullptr ? a.kv_slot[0] : b;
  const KV* kbase = static_cast<const KV*>(a.k) + bkv * a.kb + h * a.kh;
  const KV* vbase = static_cast<const KV*>(a.v) + bkv * a.vb + h * a.vh;
  const int* table =
      PAGED ? a.page_table + static_cast<long long>(b) * a.NP : nullptr;

  // keys [c0, c0 + CH) into stage st, zero outside [lo, hi] (and paged: in
  // a page outside the pool; int8: their scales 0)
  auto request = [&](int c0, int st) {
    KV* kd = k_chunk(st);
    KV* vd = v_chunk(st);
    for (int i = tid; i < CH * (D / VEC); i += THREADS) {
      const int row = i / (D / VEC);
      const int c = (i % (D / VEC)) * VEC;
      const int kpos = c0 + row;
      bool in = kpos >= lo && kpos <= hi;
      long long koff = kpos * a.ks, voff = kpos * a.vs;
      if constexpr (PAGED) {
        const int pid = in ? table[kpos / a.page] : -1;
        in = pid >= 0 && pid < a.P;
        koff = pid * a.kb + (kpos % a.page) * a.ks;
        voff = pid * a.vb + (kpos % a.page) * a.vs;
      }
      if (in) {
        copy16_async(kd + row * LD + c, kbase + koff + c);
        copy16_async(vd + row * LD + c, vbase + voff + c);
      } else {
        *reinterpret_cast<uint4*>(kd + row * LD + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd + row * LD + c) = make_uint4(0, 0, 0, 0);
      }
    }
    if constexpr (QUANT) {
      float* sc = scales(st);
      const float* ksb = a.k_scale + bkv * a.ksb;
      const float* vsb = a.v_scale + bkv * a.vsb;
      for (int row = tid; row < CH; row += THREADS) {
        const int kpos = c0 + row;
        bool in = kpos >= lo && kpos <= hi;
        long long koff = static_cast<long long>(kpos) * a.kss;
        long long voff = static_cast<long long>(kpos) * a.vss;
        if constexpr (PAGED) {
          const int pid = in ? table[kpos / a.page] : -1;
          in = pid >= 0 && pid < a.P;
          koff = pid * a.ksb + (kpos % a.page) * a.kss;
          voff = pid * a.vsb + (kpos % a.page) * a.vss;
        }
        if (in) {
          copy4_async(sc + row, ksb + koff);
          copy4_async(sc + CH + row, vsb + voff);
        } else {
          sc[row] = 0.f;
          sc[CH + row] = 0.f;
        }
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
      const KV* krow = k_chunk(st) + j * LD;
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
      if constexpr (QUANT) {
        // 16 symbols a read: with the pitch of D + 16 bytes the reads of
        // a quarter warp fall on distinct banks
#pragma unroll 2
        for (int c = 0; c < D; c += 16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
          float kf[16];
          i8_to_float(raw.x, kf);
          i8_to_float(raw.y, kf + 4);
          i8_to_float(raw.z, kf + 8);
          i8_to_float(raw.w, kf + 12);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = grp + GROUPS * i;
            if (r < R) {
              float x = acc[i];
#pragma unroll
              for (int e = 0; e < 16; e += 4) {
                const float4 q4 =
                    *reinterpret_cast<const float4*>(Qs + r * D + c + e);
                x = fmaf(q4.x, kf[e], x);
                x = fmaf(q4.y, kf[e + 1], x);
                x = fmaf(q4.z, kf[e + 2], x);
                x = fmaf(q4.w, kf[e + 3], x);
              }
              acc[i] = x;
            }
          }
        }
      } else {
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
              const float4 q0 =
                  *reinterpret_cast<const float4*>(Qs + r * D + c);
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
      }
      const int kpos = c0 + j;
      // int8: the key's scale times the score scale (0 outside the split)
      const float kscale = QUANT ? scales(st)[j] * a.scale : a.scale;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = grp + GROUPS * i;
        if (r < R) {
          const int qpos = qoff + r / a.G;
          float x = acc[i] * kscale;
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
      const float* vsc = QUANT ? scales(st) + CH : nullptr;
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
          sum += p;  // the row sum comes before the V scale
          Pt[(lane + 32 * u) * PT_LD + r] =
              QUANT ? p * vsc[lane + 32 * u] : p;
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
      const KV* vcol = v_chunk(st) + 2 * dp;
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
        float2 v;
        if constexpr (QUANT) {
          const char2 c2 = *reinterpret_cast<const char2*>(vcol + j * LD);
          v = make_float2(static_cast<float>(c2.x), static_cast<float>(c2.y));
        } else {
          v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vcol + j * LD));
        }
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

template <int D, bool SOFTCAP, typename KV, bool PAGED>
cudaError_t launch_split(const FlashArgs& a, int B, int Hkv, float* part_o,
                         float* part_ml, int nsplit, cudaStream_t stream) {
  constexpr int bytes = Geometry<D, KV>::BYTES;
  static_assert(bytes <= SMEM_LIMIT, "the split does not fit");
  static std::atomic<int> raised[64];
  cudaError_t err = raise_smem_limit(decode_split_fwd<D, SOFTCAP, KV, PAGED>,
                                     bytes, raised);
  if (err != cudaSuccess) return err;
  decode_split_fwd<D, SOFTCAP, KV, PAGED>
      <<<dim3(nsplit, Hkv, B), THREADS, bytes, stream>>>(a, part_o, part_ml,
                                                         nsplit);
  return cudaGetLastError();
}

// What the split entry points do: check the sizes, pick the variant by
// head dim and softcap, launch on `stream`. nsplit must be
// max(1, ceil(S / SPLIT)); the partials are part_o [B, H_kv, nsplit,
// T * G, D] and part_ml [.., 2] (m, l), fp32. PAGED: K/V (and int8: their
// scale pools [P, page]) are an arena read through the page table
// (S = NP * page), with every option of the dense split: the window,
// sliding or chunked, and the softcap here, the sinks at the combine.
template <typename KV, bool PAGED = false>
int split_entry(const FlashArgs* a, int B, int H, int Hkv, int D,
                void* part_o, void* part_ml, int nsplit, void* stream) {
  if (flash_bad_sizes(a, B, H, Hkv) || a->T * a->G > MAX_ROWS ||
      nsplit != (a->S + SPLIT - 1) / SPLIT + (a->S == 0)) {
    return cudaErrorInvalidValue;
  }
  if (sizeof(KV) == 1 && (a->k_scale == nullptr || a->v_scale == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (PAGED && (a->page_table == nullptr || a->kv_slot != nullptr ||
                a->NP <= 0 || a->P <= 0 || a->page <= 0 ||
                static_cast<long long>(a->NP) * a->page != a->S)) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto* po = static_cast<float*>(part_o);
  auto* pm = static_cast<float*>(part_ml);
  const bool cap = a->softcap > 0.f;
  auto run = [&](auto d) -> int {
    constexpr int Dc = decltype(d)::value;
    if (cap) {
      return launch_split<Dc, true, KV, PAGED>(*a, B, Hkv, po, pm, nsplit, s);
    }
    return launch_split<Dc, false, KV, PAGED>(*a, B, Hkv, po, pm, nsplit,
                                              s);
  };
  switch (D) {
    case 64:
      return run(std::integral_constant<int, 64>());
    case 96:
      return run(std::integral_constant<int, 96>());
    case 128:
      return run(std::integral_constant<int, 128>());
    case 256:
      return run(std::integral_constant<int, 256>());
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace split
}  // namespace lmc

// Keys a split (the wrapper sizes its scratch with it), in every library
// that holds a split decode.
extern "C" int lmc_flash_split_keys() { return lmc::split::SPLIT; }
