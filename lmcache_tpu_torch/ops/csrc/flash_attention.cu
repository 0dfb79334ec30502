// Causal GQA flash attention over a prefilled KV buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmcache_tpu/ops/attention.py::_flash_kernel
// (entry point flash_attention, pallas_call at attention.py:361). Same
// contract: q [B, T, H, D] attends to k/v rows [B, H_kv, S, D] (any strides,
// so a slot view of the serving pool needs no copy) under the mask
//     kpos <= min(q_offset[b] + t, kv_len[b] - 1),
// with an online softmax in fp32, P rounded to bf16 before the PV product
// (as the TPU kernel does), and 0 for rows that see no key.
//
// Bound on an H100: a prefill of T tokens over a context of S does
// 4 * H * D * (live key pairs) operations on T*H*D + 2*S*H_kv*D*2 bytes, far
// above the card's ~295 FLOP/byte ridge, so prefill is bound by operations:
// the products run on the tensor cores (WMMA bf16 16x16x16, fp32
// accumulate). Decode (T == 1) does ~G*4 operations per K/V byte and is bound
// by the K/V bytes: one block holds the whole GQA group of a KV head, so every
// K/V tile is read from device memory once per (sequence, KV head), not once
// per query head, and the key loop stops at the causal limit instead of
// visiting masked tiles. A split over the keys (to fill 132 SMs at small
// B * H_kv), TMA loads and wgmma are left to a later revision.
//
// Layout of one block: BM = 64 query rows = consecutive (token, head-in-group)
// pairs of one (batch, KV head), flattened token-major, so any G works. Four
// warps own 16 rows each. Per K/V tile of BN = 64 keys: S = Q K^T (WMMA, to
// shared memory) -> two lanes per row run the online softmax and write P in
// bf16 -> O (fp32, shared memory) is rescaled by alpha and O += P V (WMMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per K/V tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;  // the TPU kernel's masking constant

// Shared-memory layout in bytes. Row pitches are padded (multiples of 8
// bf16 / 4 fp32 as WMMA requires) to spread the rows over the banks; every
// array and every 16-row fragment starts on a 32-byte boundary.
template <int D>
struct Smem {
  static constexpr int LDQ = D + 8;   // bf16 Q, K and V tiles
  static constexpr int LDS = BN + 4;  // fp32 scores
  static constexpr int LDP = BN + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // fp32 output accumulator
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BM * LDQ * 2;
  static constexpr int V_OFF = K_OFF + BN * LDQ * 2;
  static constexpr int S_OFF = V_OFF + BN * LDQ * 2;
  static constexpr int P_OFF = S_OFF + BM * LDS * 4;
  static constexpr int O_OFF = P_OFF + BM * LDP * 2;
  static constexpr int BYTES = O_OFF + BM * LDO * 4;
};

struct Strides {  // in elements
  long long qb, qt, qh, kb, kh, ks, vb, vh, vs, ob, ot, oh;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ out,
          const int* __restrict__ q_offset, const int* __restrict__ kv_len,
          int T, int G, int S, Strides st, float scale) {
  using L = Smem<D>;
  constexpr int VEC = 8;  // bf16 per 16-byte load
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  // the last rows have the most keys: schedule them first
  const int f0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int rows = T * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int qoff = q_offset[b];
  const int klen = min(kv_len[b], S);
  const int t_last = min((f0 + BM - 1) / G, T - 1);
  const int kend = max(0, min(qoff + t_last + 1, klen));  // live keys [0, kend)

  const bf16* qbase = q + b * st.qb + (long long)h * G * st.qh;
  const bf16* kbase = k + b * st.kb + h * st.kh;
  const bf16* vbase = v + b * st.vb + h * st.vh;

  for (int i = tid; i < BM * D / VEC; i += THREADS) {
    const int r = i / (D / VEC);
    const int c = (i % (D / VEC)) * VEC;
    const int f = f0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (f < rows) {
      val = *reinterpret_cast<const uint4*>(
          qbase + (f / G) * st.qt + (f % G) * st.qh + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * L::LDQ + c) = val;
  }

  // two lanes per row: lane pair (2i, 2i+1) owns row warp*16 + i, each lane
  // the interleaved columns half, half + 2, ...
  const int row = warp * 16 + lane / 2;
  const int half = lane & 1;
  const int f = f0 + row;
  const int qlim = f < rows ? min(qoff + f / G, klen - 1) : -1;
  float m = NEG_INF;
  float l = 0.f;
  float* orow = Os + row * L::LDO;
  for (int d = half; d < D; d += 2) orow[d] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BN) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BN * D / VEC; i += THREADS) {
      const int r = i / (D / VEC);
      const int c = (i % (D / VEC)) * VEC;
      uint4 kv4 = make_uint4(0, 0, 0, 0);
      uint4 vv4 = make_uint4(0, 0, 0, 0);
      if (k0 + r < kend) {
        kv4 = *reinterpret_cast<const uint4*>(kbase + (k0 + r) * st.ks + c);
        vv4 = *reinterpret_cast<const uint4*>(vbase + (k0 + r) * st.vs + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * L::LDQ + c) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * L::LDQ + c) = vv4;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    for (int j = 0; j < BN / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + warp * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::load_matrix_sync(bt, Ks + j * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * L::LDS + j * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of this row's BN scores
    const float* srow = Ss + row * L::LDS;
    bf16* prow = Ps + row * L::LDP;
    float mx = NEG_INF;
    for (int c = half; c < BN; c += 2) {
      if (k0 + c <= qlim) mx = fmaxf(mx, srow[c] * scale);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
    for (int c = half; c < BN; c += 2) {
      const float p = k0 + c <= qlim ? expf(srow[c] * scale - m_new) : 0.f;
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = alpha * l + sum;
    m = m_new;
    for (int d = half; d < D; d += 2) orow[d] *= alpha;
    __syncwarp();

    // O += P V
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* otile = Os + warp * 16 * L::LDO + j * 16;
      wmma::load_matrix_sync(acc, otile, L::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + warp * 16 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(otile, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncwarp();  // with no live tile, the partner lane zeroed half the row

  if (f < rows) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no live key -> 0
    bf16* dst = out + b * st.ob + (f / G) * st.ot +
                ((long long)h * G + f % G) * st.oh;
    for (int d = 2 * half; d < D; d += 4) {
      *reinterpret_cast<__nv_bfloat162*>(dst + d) =
          __floats2bfloat162_rn(orow[d] * inv, orow[d + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   const int* q_offset, const int* kv_len, int B, int T,
                   int Hkv, int G, int S, const Strides& st, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;  // above the 48 KB default
  // the limit is a per-device attribute of the function: raise it once per
  // device, not before every launch
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(
        flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid((T * G + BM - 1) / BM, Hkv, B);
  flash_fwd<D><<<grid, THREADS, bytes, stream>>>(q, k, v, out, q_offset,
                                                 kv_len, T, G, S, st, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers,
// strides are in elements; returns a cudaError_t (0 on success).
extern "C" int lmc_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* out,
    const void* q_offset, const void* kv_len, int B, int T, int H, int Hkv,
    int S, int D, long long sqb, long long sqt, long long sqh, long long skb,
    long long skh, long long sks, long long svb, long long svh,
    long long svs, long long sob, long long sot, long long soh, float scale,
    void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  const Strides st{sqb, sqt, sqh, skb, skh, sks, svb, svh, svs, sob, sot, soh};
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(out);
  const auto* qo = static_cast<const int*>(q_offset);
  const auto* kl = static_cast<const int*>(kv_len);
  auto s = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  switch (D) {
    case 64:
      return launch<64>(qp, kp, vp, op, qo, kl, B, T, Hkv, G, S, st, scale, s);
    case 128:
      return launch<128>(qp, kp, vp, op, qo, kl, B, T, Hkv, G, S, st, scale,
                         s);
    default:
      return cudaErrorInvalidValue;
  }
}
