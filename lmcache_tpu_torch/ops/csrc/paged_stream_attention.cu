// Paged attention that streams the live pages, for Hopper (sm_90a): the
// decode-oriented paged kernel, head dims 64, 128 and 256.
//
// Replaces the TPU kernels
// lmcache_tpu/ops/paged_attention.py::_paged_dma_kernel (entry point
// paged_attention_dma, row 6) and ::_paged_dma_kernel_q (entry point
// quantized_paged_attention_dma, row 7). Same contract as
// paged_attention.cu.
//
// Row 6, bf16 arenas: the design of paged_attention.cu's row 4, the Hopper
// body of flash_sm90.cuh over the arena read through the page table, at
// the deepest ring of TMA stages that shared memory holds (6 at D 64, 3 at
// D 128, 2 at D 256; row 2's), which is what stays of the TPU kernel's own
// ring of DMAs; launches of at most 16 rows T * G (every decode step) run
// the paged key-split decode of flash_split.cuh and flash_attention.cu's
// combine. Bound on an H100: prefill by the tensor-core operations, decode
// by the live K/V bytes (~4 G operations a byte): at tinyllama's decode
// (B 4, H_kv 4) one block a (sequence, KV head) would leave 16 blocks on
// 132 SMs; the split puts B * H_kv * NP * page / 256 blocks on them.
//
// Row 7, int8 arenas: paged_stream_fwd<D, int8> below, a WMMA body.
// What carries over from the TPU kernel is the work per step, not its
// layout: the loop runs over the live page slots only (ceil(kv_len / page),
// the causal limit, the window's first page); one key tile is `sp` page
// slots (up to 512 tokens, fewer where shared memory is short), gathered
// through the page table into shared memory; one score product and one
// online-softmax update per tile; trailing dead slots of a tile are
// zero-filled and masked, never fetched (nor is a page id outside the
// pool). int8 pages pass through registers to be converted, so they load
// synchronously: K of tile g+1 once the scores of tile g are out, V of tile
// g+1 after the PV product. B * H_kv * ceil(T G / 16) blocks run; a split
// over the keys, TMA and wgmma are left to a later revision. Layout of one
// block: BM = 16 query rows = consecutive (token, head-in-group) pairs,
// token-major (decode: the GQA group of one KV head), eight warps. Score
// product: warp w takes the 16-key column tiles w, w + 8, ...; softmax: 16
// lanes per row; PV: warp w takes the output column tiles w, w + 8, ...
// over the tile's live keys.

#include "flash_sm90.cuh"
#include "flash_split.cuh"
#include "paged_common.cuh"

namespace {

using namespace nvcuda;
using lmc::bf16;
using lmc::i8;
using lmc::NEG_INF;
using lmc::PagedArgs;

constexpr int BM = 16;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LPR = THREADS / BM;  // lanes per softmax row

// Shared memory in bytes for a tile of TN = sp * page keys; every array
// and 16-row fragment starts on a 32-byte boundary.
__host__ __device__ constexpr int smem_bytes(int D, int TN) {
  return BM * (D + 8) * 2          // Q
         + 2 * TN * (D + 8) * 2    // K, V
         + BM * (TN + 4) * 4       // S
         + BM * (TN + 8) * 2       // P
         + BM * (D + 4) * 4        // O
         + 4 * TN * 4;             // k/v scales, two tiles each
}

template <int D, typename KV>
__global__ void __launch_bounds__(THREADS)
paged_stream_fwd(const PagedArgs a) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int VEC = lmc::Vec<KV>::N;
  constexpr int LDQ = D + 8;
  constexpr int LDO = D + 4;
  const int page = a.page;
  const int TN = a.sp * page;
  const int LDS = TN + 4;
  const int LDP = TN + 8;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * LDQ;
  bf16* Vs = Ks + TN * LDQ;
  float* Ss = reinterpret_cast<float*>(Vs + TN * LDQ);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BM * LDS);
  float* Os = reinterpret_cast<float*>(Ps + BM * LDP);
  float* ksc = Os + BM * LDO;  // [2][TN]
  float* vsc = ksc + 2 * TN;   // [2][TN]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int f0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int G = a.G;
  const int rows = a.T * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  const int qoff = a.q_offset[b];
  const int klen = min(a.kv_len[b], a.NP * page);
  const int t_first = f0 / G;
  const int t_last = min((f0 + BM - 1) / G, a.T - 1);
  const int kend = max(0, min(qoff + t_last + 1, klen));  // live keys end
  const int live_pg = (kend + page - 1) / page;
  const int start_pg =
      a.window > 0 ? max(qoff + t_first - a.window + 1, 0) / page : 0;
  const int num_g = live_pg > start_pg
                        ? (live_pg - start_pg + a.sp - 1) / a.sp
                        : 0;

  const bf16* qbase = static_cast<const bf16*>(a.q) + b * a.qb +
                      (long long)h * G * a.qh;
  const KV* kpool = static_cast<const KV*>(a.k) + h * a.kh;
  const KV* vpool = static_cast<const KV*>(a.v) + h * a.vh;
  const int* table = a.page_table + (long long)b * a.NP;

  // gather tile g of one pool into its buffer; dead slots, dead rows and
  // page ids outside the pool are zero-filled
  auto load_tile = [&](int g, const KV* pool, long long sp_, long long ss_,
                       bf16* dst, const float* scale_pool, long long ssc_,
                       float* scale_dst) {
    const int slot0 = start_pg + g * a.sp;
    for (int i = tid; i < TN * (D / VEC); i += THREADS) {
      const int r = i / (D / VEC);
      const int c = (i % (D / VEC)) * VEC;
      const int slot = slot0 + r / page;
      const int off = r % page;
      bf16* d = dst + r * LDQ + c;
      int pid = -1;
      if (slot < live_pg && slot * page + off < kend) pid = table[slot];
      if (pid >= 0 && pid < a.P) {
        lmc::load_async(d, pool + pid * sp_ + off * ss_ + c);
      } else {
        lmc::store_zero<VEC>(d);
      }
    }
    if (QUANT) {
      for (int r = tid; r < TN; r += THREADS) {
        const int slot = slot0 + r / page;
        int pid = -1;
        if (slot < live_pg) pid = table[slot];
        scale_dst[r] = (pid >= 0 && pid < a.P)
                           ? scale_pool[pid * ssc_ + r % page]
                           : 0.f;
      }
    }
  };

  for (int i = tid; i < BM * D / 8; i += THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int f = f0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (f < rows) {
      val = *reinterpret_cast<const uint4*>(qbase + (f / G) * a.qt +
                                            (f % G) * a.qh + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c) = val;
  }

  // LPR lanes per row: lanes sub, sub + LPR, ... of row tid / LPR
  const int row = tid / LPR;
  const int sub = tid % LPR;
  const int f = f0 + row;
  const int qpos = qoff + f / G;
  const int qlim = f < rows ? min(qpos, klen - 1) : -1;
  const int wlo = a.window > 0 ? qpos - a.window : -0x40000000;  // kpos > wlo
  float m = NEG_INF;
  float l = 0.f;
  float* orow = Os + row * LDO;
  for (int d = sub; d < D; d += LPR) orow[d] = 0.f;

  if (num_g > 0) {
    load_tile(0, kpool, a.kp, a.ks, Ks, a.k_scale, a.scp, ksc);
  }
  lmc::async_commit();
  if (num_g > 0) {
    load_tile(0, vpool, a.vp, a.vs, Vs, a.v_scale, a.svp, vsc);
  }
  lmc::async_commit();

  for (int g = 0; g < num_g; ++g) {
    const int k0 = (start_pg + g * a.sp) * page;
    // 16-key column tiles of this tile that hold a live key
    const int kt = (min(TN, kend - k0) + 15) / 16;
    const int ncols = kt * 16;
    const float* ks_t = ksc + (g & 1) * TN;
    const float* vs_t = vsc + (g & 1) * TN;

    lmc::async_wait<1>();  // K of tile g has landed
    __syncthreads();

    // S = Q K^T
    for (int j = warp; j < kt; j += WARPS) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(qa, Qs + kk * 16, LDQ);
        wmma::load_matrix_sync(kb, Ks + j * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(acc, qa, kb, acc);
      }
      wmma::store_matrix_sync(Ss + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncthreads();  // scores are out; the K buffer is free

    if (g + 1 < num_g) {
      load_tile(g + 1, kpool, a.kp, a.ks, Ks, a.k_scale, a.scp,
                ksc + ((g + 1) & 1) * TN);
    }
    lmc::async_commit();

    // online softmax of this row's scores
    const float* srow = Ss + row * LDS;
    bf16* prow = Ps + row * LDP;
    float mx = NEG_INF;
    for (int c = sub; c < ncols; c += LPR) {
      const int kpos = k0 + c;
      if (kpos <= qlim && kpos > wlo) {
        float s = srow[c] * a.scale;
        if (QUANT) s *= ks_t[c];
        mx = fmaxf(mx, s);
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o /= 2) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
    for (int c = sub; c < ncols; c += LPR) {
      const int kpos = k0 + c;
      float p = 0.f;
      if (kpos <= qlim && kpos > wlo) {
        float s = srow[c] * a.scale;
        if (QUANT) s *= ks_t[c];
        p = expf(s - m_new);
      }
      sum += p;  // the row sum comes before the V scale
      if (QUANT) p *= vs_t[c];
      prow[c] = __float2bfloat16(p);
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o /= 2) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    l = alpha * l + sum;
    m = m_new;
    for (int d = sub; d < D; d += LPR) orow[d] *= alpha;

    lmc::async_wait<1>();  // V of tile g has landed
    __syncthreads();       // P and the rescaled O are visible

    // O += P V over the live column tiles
    for (int j = warp; j < D / 16; j += WARPS) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* otile = Os + j * 16;
      wmma::load_matrix_sync(acc, otile, LDO, wmma::mem_row_major);
      for (int kk = 0; kk < kt; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Ps + kk * 16, LDP);
        wmma::load_matrix_sync(vb, Vs + kk * 16 * LDQ + j * 16, LDQ);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(otile, acc, LDO, wmma::mem_row_major);
    }
    __syncthreads();  // the V buffer and P are free

    if (g + 1 < num_g) {
      load_tile(g + 1, vpool, a.vp, a.vs, Vs, a.v_scale, a.svp,
                vsc + ((g + 1) & 1) * TN);
    }
    lmc::async_commit();
  }
  lmc::async_wait<0>();
  __syncthreads();  // O is final (or still zero) for every lane of the row

  if (f < rows) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no live key -> 0
    bf16* dst = static_cast<bf16*>(a.out) + b * a.ob + (f / G) * a.ot +
                ((long long)h * G + f % G) * a.oh;
    for (int d = 2 * sub; d < D; d += 2 * LPR) {
      *reinterpret_cast<__nv_bfloat162*>(dst + d) =
          __floats2bfloat162_rn(orow[d] * inv, orow[d + 1] * inv);
    }
  }
}

template <int D, typename KV>
cudaError_t launch(const PagedArgs& a, int B, int Hkv, cudaStream_t stream) {
  const int bytes = smem_bytes(D, a.sp * a.page);
  if (bytes > lmc::SMEM_LIMIT) return cudaErrorInvalidValue;
  static std::atomic<int> raised[64];
  cudaError_t err =
      lmc::raise_smem_limit(paged_stream_fwd<D, KV>, bytes, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T * a.G + BM - 1) / BM, Hkv, B);
  paged_stream_fwd<D, KV><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t dispatch(const PagedArgs& a, int B, int Hkv, int D,
                     cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64, KV>(a, B, Hkv, stream);
    case 128:
      return launch<128, KV>(a, B, Hkv, stream);
    case 256:
      return launch<256, KV>(a, B, Hkv, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// row 6's Hopper body over the arena, at the deepest ring that fits
template <int D>
cudaError_t hopper_launch(const lmc::FlashArgs& a, int B, int Hkv,
                          cudaStream_t stream) {
  constexpr int stages = lmc::sm90::Geometry<D>::max_stages();
  return lmc::sm90::launch<D, stages, false, bf16, true>(a, B, Hkv, stream);
}

}  // namespace

// Shared memory (bytes) one block needs for tiles of `sp` page slots, so
// that the wrapper can size the tile before it launches.
extern "C" int lmc_paged_stream_attention_smem_bytes(int D, int page,
                                                     int sp) {
  return smem_bytes(D, sp * page);
}

// Row 6's prefill body, as lmc_paged_attention_bf16 of paged_attention.cu
// at the deepest ring.
extern "C" int lmc_paged_stream_attention_bf16(const lmc::FlashArgs* a,
                                               int B, int H, int Hkv, int D,
                                               void* stream) {
  if (lmc::flash_bad_sizes(a, B, H, Hkv) || a->softcap > 0.f ||
      a->sinks != nullptr || a->chunked) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return hopper_launch<64>(*a, B, Hkv, s);
    case 128:
      return hopper_launch<128>(*a, B, Hkv, s);
    case 256:
      return hopper_launch<256>(*a, B, Hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Row 6's split decode, its first kernel, as
// lmc_paged_attention_decode_split_bf16 of paged_attention.cu.
extern "C" int lmc_paged_stream_attention_decode_split_bf16(
    const lmc::FlashArgs* a, int B, int H, int Hkv, int D, void* part_o,
    void* part_ml, int nsplit, void* stream) {
  if (a == nullptr || a->sinks != nullptr || a->chunked) {
    return cudaErrorInvalidValue;
  }
  return lmc::split::split_entry<lmc::bf16, true>(a, B, H, Hkv, D, part_o,
                                                  part_ml, nsplit, stream);
}

extern "C" int lmc_paged_stream_attention_int8(LMC_PAGED_PARAMS) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (lmc::bad_sizes(B, T, H, Hkv, NP, P, page, sp)) {
    return cudaErrorInvalidValue;
  }
  if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
  LMC_PAGED_ARGS_INIT;
  return dispatch<i8>(a, B, Hkv, D, static_cast<cudaStream_t>(stream));
}
