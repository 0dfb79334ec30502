// Attention over a page-table-indexed KV arena, one page per step on the
// TPU, for Hopper (sm_90a): the general paged kernel.
//
// Replaces the TPU kernels lmcache_tpu/ops/paged_attention.py::_paged_kernel
// (entry point paged_attention, row 4) and ::_paged_kernel_q (entry point
// quantized_paged_attention, row 5); both share _paged_body there.
// Contract: q [B, T, H, D] attends to the pages page_table[b, :] of the K/V
// pools [P, H_kv, page, D] under
//     kpos <= min(q_offset[b] + t, kv_len[b] - 1)  and, with a window W,
//     kpos >  q_offset[b] + t - W,
// online softmax in fp32, P rounded to bf16 before the PV product, 0 for a
// row that sees no key (so also for kv_len == 0).
//
// Row 4, bf16 arenas: the Hopper body of rows 1-3 (flash_sm90.cuh) with the
// arena as its tile source, read in place through the page table: a TMA
// box a page piece and panel, the page ids loaded by the producer warp,
// two wgmma consumer warpgroups with S, P and O in registers, the ring of
// row 1 (2 stages). Launches of at most 16 rows T * G (every decode step)
// run the key-split decode of flash_split.cuh over the arena (cp.async
// copies through the page table, splits at absolute multiples of 256
// keys), and flash_attention.cu's combine merges the partials. The TPU
// kernel steps a sequential grid axis over every page-table slot and pins
// the DMA of dead slots to a live page; here only the live pieces are
// read. Bound on an H100: prefill by the tensor-core operations (4 H D a
// live pair), decode by the live K/V bytes (~4 G operations a byte; Phi-3
// at G 1: one block a (sequence, KV head) walking its ~33 window pages
// would leave 64 blocks on 132 SMs, the split puts B * H_kv * splits on
// them).
//
// Row 5, int8 arenas: paged_fwd<D, int8> below, a WMMA body, any head dim
// that is a multiple of 16. int8 pages convert to bf16 in registers
// (exact); the per-token scales correct the score columns (s *= k_scale)
// and the probability columns (p *= v_scale, after the row sum). One block
// owns a (batch, KV head, 64-row q block) and loops over the live pages
// only: those below kv_len, at or below the block's causal diagonal and,
// with a window, not wholly older than the block's oldest query. Bound as
// row 4, at half the K/V bytes; a split over the keys, cp.async/TMA and
// wgmma are left to a later revision. Layout of one block: BM = 64 query
// rows = consecutive (token, head-in-group) pairs, token-major, four warps
// of 16 rows; warps with no live row (decode with a small group) only help
// load. Per page: S = Q K^T -> two lanes per row run the online softmax and
// write P in bf16 -> O (fp32, shared memory) is rescaled and O += P V.

#include "flash_sm90.cuh"
#include "flash_split.cuh"
#include "paged_common.cuh"

namespace {

using namespace nvcuda;
using lmc::bf16;
using lmc::i8;
using lmc::NEG_INF;
using lmc::PagedArgs;

constexpr int BM = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// Shared memory in bytes; every array and 16-row fragment starts on a
// 32-byte boundary (page is a multiple of 16, D a multiple of 16).
__host__ __device__ constexpr int smem_bytes(int D, int page) {
  return BM * (D + 8) * 2            // Q
         + 2 * page * (D + 8) * 2    // K, V
         + BM * (page + 4) * 4       // S
         + BM * (page + 8) * 2       // P
         + BM * (D + 4) * 4          // O
         + 2 * page * 4;             // k/v scales
}

template <int D, typename KV>
__global__ void __launch_bounds__(THREADS) paged_fwd(const PagedArgs a) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int VEC = lmc::Vec<KV>::N;
  constexpr int LDQ = D + 8;
  constexpr int LDO = D + 4;
  const int page = a.page;
  const int LDS = page + 4;
  const int LDP = page + 8;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * LDQ;
  bf16* Vs = Ks + page * LDQ;
  float* Ss = reinterpret_cast<float*>(Vs + page * LDQ);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BM * LDS);
  float* Os = reinterpret_cast<float*>(Ps + BM * LDP);
  float* ksc = Os + BM * LDO;
  float* vsc = ksc + page;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  // the last rows have the most keys: schedule them first
  const int f0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int G = a.G;
  const int rows = a.T * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int qoff = a.q_offset[b];
  const int klen = min(a.kv_len[b], a.NP * page);
  const int t_first = f0 / G;
  const int t_last = min((f0 + BM - 1) / G, a.T - 1);
  const int kend = max(0, min(qoff + t_last + 1, klen));  // live keys end
  const int end_pg = (kend + page - 1) / page;
  const int start_pg =
      a.window > 0 ? max(qoff + t_first - a.window + 1, 0) / page : 0;

  const bf16* qbase = static_cast<const bf16*>(a.q) + b * a.qb +
                      (long long)h * G * a.qh;
  const KV* kpool = static_cast<const KV*>(a.k) + h * a.kh;
  const KV* vpool = static_cast<const KV*>(a.v) + h * a.vh;
  const int* table = a.page_table + (long long)b * a.NP;

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

  // two lanes per row: lane pair (2i, 2i+1) owns row warp*16 + i, each lane
  // the interleaved columns half, half + 2, ...
  const int row = warp * 16 + lane / 2;
  const int half = lane & 1;
  const int f = f0 + row;
  const int qpos = qoff + f / G;
  const int qlim = f < rows ? min(qpos, klen - 1) : -1;
  const int wlo = a.window > 0 ? qpos - a.window : -0x40000000;  // kpos > wlo
  const bool warp_live = f0 + warp * 16 < rows;
  float m = NEG_INF;
  float l = 0.f;
  float* orow = Os + row * LDO;
  for (int d = half; d < D; d += 2) orow[d] = 0.f;

  for (int pg = start_pg; pg < end_pg; ++pg) {
    const int k0 = pg * page;
    const int pid = table[pg];
    const bool valid = pid >= 0 && pid < a.P;  // never read past the pool
    __syncthreads();  // the previous page is no longer read
    for (int i = tid; i < page * (D / VEC); i += THREADS) {
      const int r = i / (D / VEC);
      const int c = (i % (D / VEC)) * VEC;
      bf16* kd = Ks + r * LDQ + c;
      bf16* vd = Vs + r * LDQ + c;
      if (valid && k0 + r < kend) {
        lmc::load_convert(kd, kpool + pid * a.kp + r * a.ks + c);
        lmc::load_convert(vd, vpool + pid * a.vp + r * a.vs + c);
      } else {
        lmc::store_zero<VEC>(kd);
        lmc::store_zero<VEC>(vd);
      }
    }
    if (QUANT) {
      for (int r = tid; r < page; r += THREADS) {
        ksc[r] = valid ? a.k_scale[pid * a.scp + r] : 0.f;
        vsc[r] = valid ? a.v_scale[pid * a.svp + r] : 0.f;
      }
    }
    __syncthreads();
    if (!warp_live) continue;  // warp-uniform; block barriers stay matched

    // S = Q K^T for this warp's 16 rows
    for (int j = 0; j < page / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(qa, Qs + warp * 16 * LDQ + kk * 16, LDQ);
        wmma::load_matrix_sync(kb, Ks + j * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(acc, qa, kb, acc);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * LDS + j * 16, acc, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of this row's scores
    const float* srow = Ss + row * LDS;
    bf16* prow = Ps + row * LDP;
    float mx = NEG_INF;
    for (int c = half; c < page; c += 2) {
      const int kpos = k0 + c;
      if (kpos <= qlim && kpos > wlo) {
        float s = srow[c] * a.scale;
        if (QUANT) s *= ksc[c];
        mx = fmaxf(mx, s);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
    for (int c = half; c < page; c += 2) {
      const int kpos = k0 + c;
      float p = 0.f;
      if (kpos <= qlim && kpos > wlo) {
        float s = srow[c] * a.scale;
        if (QUANT) s *= ksc[c];
        p = expf(s - m_new);
      }
      sum += p;  // the row sum comes before the V scale
      if (QUANT) p *= vsc[c];
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
      float* otile = Os + warp * 16 * LDO + j * 16;
      wmma::load_matrix_sync(acc, otile, LDO, wmma::mem_row_major);
      for (int kk = 0; kk < page / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Ps + warp * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(vb, Vs + kk * 16 * LDQ + j * 16, LDQ);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(otile, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncwarp();  // with no live page, the partner lane zeroed half the row

  if (f < rows) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no live key -> 0
    bf16* dst = static_cast<bf16*>(a.out) + b * a.ob + (f / G) * a.ot +
                ((long long)h * G + f % G) * a.oh;
    for (int d = 2 * half; d < D; d += 4) {
      *reinterpret_cast<__nv_bfloat162*>(dst + d) =
          __floats2bfloat162_rn(orow[d] * inv, orow[d + 1] * inv);
    }
  }
}

template <int D, typename KV>
cudaError_t launch(const PagedArgs& a, int B, int Hkv, cudaStream_t stream) {
  const int bytes = smem_bytes(D, a.page);
  if (bytes > lmc::SMEM_LIMIT) return cudaErrorInvalidValue;
  static std::atomic<int> raised[64];
  cudaError_t err = lmc::raise_smem_limit(paged_fwd<D, KV>, bytes, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T * a.G + BM - 1) / BM, Hkv, B);
  paged_fwd<D, KV><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t dispatch(const PagedArgs& a, int B, int Hkv, int D,
                     cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64, KV>(a, B, Hkv, stream);
    case 96:
      return launch<96, KV>(a, B, Hkv, stream);
    case 128:
      return launch<128, KV>(a, B, Hkv, stream);
    case 256:
      return launch<256, KV>(a, B, Hkv, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory (bytes) one block needs, so that the wrapper can refuse a
// page size or head dim that does not fit before it launches.
extern "C" int lmc_paged_attention_smem_bytes(int D, int page) {
  return smem_bytes(D, page);
}

// Row 4's prefill body: the argument block (device pointers, strides in
// elements, the page-table fields set) and the sizes it does not hold; the
// options the paged entry points refuse must be off.
extern "C" int lmc_paged_attention_bf16(const lmc::FlashArgs* a, int B,
                                        int H, int Hkv, int D, void* stream) {
  using lmc::sm90::launch;
  if (lmc::flash_bad_sizes(a, B, H, Hkv) || a->softcap > 0.f ||
      a->sinks != nullptr || a->chunked) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, 2, false, lmc::bf16, true>(*a, B, Hkv, s);
    case 96:
      return launch<96, 2, false, lmc::bf16, true>(*a, B, Hkv, s);
    case 128:
      return launch<128, 2, false, lmc::bf16, true>(*a, B, Hkv, s);
    case 256:
      return launch<256, 2, false, lmc::bf16, true>(*a, B, Hkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Row 4's split decode, its first kernel: partials of T * G <= 16 rows into
// part_o [B, H_kv, nsplit, T * G, D] and part_ml [.., 2] (m, l), fp32, with
// nsplit = max(1, ceil(NP * page / SPLIT)); lmc_flash_combine_partials of
// flash_attention.cu merges them.
extern "C" int lmc_paged_attention_decode_split_bf16(
    const lmc::FlashArgs* a, int B, int H, int Hkv, int D, void* part_o,
    void* part_ml, int nsplit, void* stream) {
  if (a == nullptr || a->sinks != nullptr || a->chunked) {
    return cudaErrorInvalidValue;
  }
  return lmc::split::split_entry<lmc::bf16, true>(a, B, H, Hkv, D, part_o,
                                                  part_ml, nsplit, stream);
}

extern "C" int lmc_paged_attention_int8(LMC_PAGED_PARAMS) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (lmc::bad_sizes(B, T, H, Hkv, NP, P, page, sp)) {
    return cudaErrorInvalidValue;
  }
  if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
  LMC_PAGED_ARGS_INIT;
  return dispatch<i8>(a, B, Hkv, D, static_cast<cudaStream_t>(stream));
}
