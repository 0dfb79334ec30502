// The body of the paged MLA latent-attention kernels
// (paged_latent_attention.cu, rows 9 and 10) and the argument block of all
// three (the dense kernel of latent_attention.cu, row 8, runs the Hopper
// body of latent_sm90.cuh): absorbed multi-head latent attention, where
// one cached latent row [c ; k_pe] of C columns is the key of every query
// head and its first r columns (c) are the value.
//
// Contract: q_full [B, T, H, C] bf16 (rows of any strides with unit stride
// along C) attends to the sequence's latent rows under
//     kpos <= min(q_offset[b] + t, kv_len[b] - 1);
// dense rows are [B, S, >= C] (a layer's slice of the pool, read in place),
// paged rows [P, page, >= C] named by page_table [B, NP]; only the first C
// columns of a row are read (the paged arenas carry a zero lane pad past
// C). int8 rows carry one fp32 scale per token ([B, S] or [P, page]), which
// multiplies the score column (times the score scale) and the probability
// column before P is rounded to bf16, as the TPU kernels do. Output
// [B, T, H, r] bf16 (the latent-space context); a row that sees no key
// gives 0.
//
// Rows are the flattened (head, token) pairs g = h * T + t, as in the TPU
// kernels: all heads share the one latent stream (MQA), so a decode step
// has H real rows, and a block of BM = 16 or 32 of them (BM sized from
// H * T by the wrapper) reads each key tile once for all its heads.
//
// Layout of one block (8 warps; BM rows of one sequence): Q [BM, C], STAGES
// key tiles [tn, C], scores S [BM, tn] fp32, probabilities P [BM, tn] bf16
// and the output accumulator O [BM, r] fp32, all in shared memory (at
// C = 576, r = 512: 187-208 KB). Per tile: S = Q K^T (WMMA bf16
// 16x16x16, fp32 accumulate; warps take the 16x16 tiles in turn) -> LPR =
// 256 / BM lanes per row run the online softmax, write P in bf16 and
// rescale the row of O -> O += P K[:, :r] from the same shared-memory tile
// (warps take O's 16x16 tiles in turn). The key tile is read from device
// memory once per block and serves both products.
//
// STAGES == 1: the tile is loaded, then computed (row 9). STAGES ==
// 2: the next tile's cp.async loads are issued before this tile is computed
// (row 10); int8 rows pass through registers to be converted either way.

#pragma once

#include "paged_common.cuh"

namespace lmc {

constexpr int LAT_WARPS = 8;
constexpr int LAT_THREADS = LAT_WARPS * 32;

// Filled by the Python wrapper (a ctypes.Structure with the same fields in
// the same order); strides in elements.
struct LatentArgs {
  const void* q;
  const void* kv;          // dense [B, S, >= C] or paged [P, page, >= C]
  void* out;               // [B, T, H, r]
  const float* kv_scale;   // int8: dense [B, S] or paged [P, page]
  const int* page_table;   // paged: [B, NP]
  const int* q_offset;
  const int* kv_len;
  int T, H, C, r;
  int S;                   // keys a sequence can hold (paged: NP * page)
  int NP, P, page;         // paged only
  int tn;                  // keys per tile, a multiple of 16
  float scale;
  // q and out [B, T, H]; rows: kb the batch (dense) or page (paged) stride,
  // ks the row stride; scales: sb, ss likewise
  long long qb, qt, qh, kb, ks, ob, ot, oh, sb, ss;
};

// Shared memory of one block in bytes; every array and every 16-row
// fragment starts on a 32-byte boundary.
__host__ __device__ inline int latent_smem_bytes(int BM, int C, int r, int tn,
                                                 int stages) {
  return BM * (C + 8) * 2             // Q
         + stages * tn * (C + 8) * 2  // key tiles
         + BM * (tn + 4) * 4          // S
         + BM * (tn + 8) * 2          // P
         + BM * (r + 4) * 4           // O
         + stages * tn * 4;           // per-key scales (int8)
}

template <int BM, typename KV, int STAGES>
__device__ __forceinline__ void latent_body(const LatentArgs& a) {
  using namespace nvcuda;
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int VEC = Vec<KV>::N;
  constexpr int LPR = LAT_THREADS / BM;  // lanes per softmax row
  const int C = a.C, r = a.r, TN = a.tn;
  const int LDK = C + 8, LDS = TN + 4, LDP = TN + 8, LDO = r + 4;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * LDK;
  float* Ss = reinterpret_cast<float*>(Ks + STAGES * TN * LDK);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BM * LDS);
  float* Os = reinterpret_cast<float*>(Ps + BM * LDP);
  float* Sc = Os + BM * LDO;  // [STAGES][tn]

  const int b = blockIdx.y;
  const int R = a.H * a.T;
  // the rows of a head's newest tokens have the most keys: schedule them
  // first
  const int f0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int qoff = a.q_offset[b];
  const int klen = min(a.kv_len[b], a.S);
  // the block's newest token: the last row's, unless the rows cross a head
  const int f_last = min(f0 + BM, R) - 1;
  const int t_max = f_last / a.T == f0 / a.T ? f_last % a.T : a.T - 1;
  const int kend = max(0, min(qoff + t_max + 1, klen));  // live keys end
  const int num_g = (kend + TN - 1) / TN;

  const KV* rows = static_cast<const KV*>(a.kv);
  const int* table = a.page_table + (long long)b * a.NP;

  // the element offset of key k's row, or -1 where it is not read: past the
  // live keys, or a page id outside the pool
  auto row_offset = [&](int k, long long kb, long long ks) -> long long {
    if (k >= kend) return -1;
    const int pid = table[k / a.page];
    if (pid < 0 || pid >= a.P) return -1;
    return pid * kb + (k % a.page) * ks;
  };

  // tile g into buffer buf: zero where a row is not read
  auto load_tile = [&](int g, int buf) {
    const int k0 = g * TN;
    bf16* dst = Ks + buf * TN * LDK;
    const int per_row = C / VEC;
    for (int i = tid; i < TN * per_row; i += LAT_THREADS) {
      const int row = i / per_row;
      const int c = (i % per_row) * VEC;
      bf16* d = dst + row * LDK + c;
      const long long off = row_offset(k0 + row, a.kb, a.ks);
      if (off >= 0) {
        load_async(d, rows + off + c);
      } else {
        store_zero<VEC>(d);
      }
    }
    if (QUANT) {
      float* sdst = Sc + buf * TN;
      for (int row = tid; row < TN; row += LAT_THREADS) {
        const long long off = row_offset(k0 + row, a.sb, a.ss);
        sdst[row] = off >= 0 ? a.kv_scale[off] : 0.f;
      }
    }
  };

  // Q rows of the block (zero past the last row)
  const bf16* qbase = static_cast<const bf16*>(a.q) + b * a.qb;
  for (int i = tid; i < BM * (C / 8); i += LAT_THREADS) {
    const int row = i / (C / 8);
    const int c = (i % (C / 8)) * 8;
    const int f = f0 + row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (f < R) {
      val = *reinterpret_cast<const uint4*>(qbase + (f % a.T) * a.qt +
                                            (f / a.T) * a.qh + c);
    }
    *reinterpret_cast<uint4*>(Qs + row * LDK + c) = val;
  }

  // LPR lanes per row: lanes sub, sub + LPR, ... of row tid / LPR
  const int row = tid / LPR;
  const int sub = tid % LPR;
  const int f = f0 + row;
  const int qlim = f < R ? min(qoff + f % a.T, klen - 1) : -1;
  float m = NEG_INF;
  float l = 0.f;
  float* orow = Os + row * LDO;
  for (int d = sub; d < r; d += LPR) orow[d] = 0.f;

  if (STAGES == 2) {
    if (num_g > 0) load_tile(0, 0);
    async_commit();
  }
  for (int g = 0; g < num_g; ++g) {
    const int buf = STAGES == 2 ? (g & 1) : 0;
    if (STAGES == 1) {
      __syncthreads();  // the previous tile is no longer read
      load_tile(g, 0);
      async_commit();
      async_wait<0>();
    } else {
      // the buffer of tile g + 1 was freed at the end of iteration g - 1
      if (g + 1 < num_g) load_tile(g + 1, (g + 1) & 1);
      async_commit();
      async_wait<1>();  // tile g has landed
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * TN * LDK;
    const float* sc = Sc + buf * TN;
    const int k0 = g * TN;
    const int kt = (min(TN, kend - k0) + 15) / 16;  // live 16-key columns

    // S = Q K^T over all C columns
    for (int j = warp; j < (BM / 16) * kt; j += LAT_WARPS) {
      const int rt = j / kt;
      const int ct = j % kt;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < C / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(qa, Qs + rt * 16 * LDK + kk * 16, LDK);
        wmma::load_matrix_sync(kb, Kt + ct * 16 * LDK + kk * 16, LDK);
        wmma::mma_sync(acc, qa, kb, acc);
      }
      wmma::store_matrix_sync(Ss + rt * 16 * LDS + ct * 16, acc, LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax of this row's scores
    const float* srow = Ss + row * LDS;
    bf16* prow = Ps + row * LDP;
    const int ncols = kt * 16;
    float mx = NEG_INF;
    for (int c = sub; c < ncols; c += LPR) {
      if (k0 + c <= qlim) {
        const float s = QUANT ? srow[c] * (sc[c] * a.scale) : srow[c] * a.scale;
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
      float p = 0.f;
      if (k0 + c <= qlim) {
        const float s = QUANT ? srow[c] * (sc[c] * a.scale) : srow[c] * a.scale;
        p = expf(s - m_new);
      }
      sum += p;  // the row sum comes before the key's scale
      if (QUANT) p *= sc[c];
      prow[c] = __float2bfloat16(p);
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o /= 2) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    l = alpha * l + sum;
    m = m_new;
    for (int d = sub; d < r; d += LPR) orow[d] *= alpha;
    __syncthreads();  // P and the rescaled O are visible

    // O += P K[:, :r]: the value is the same tile's latent prefix
    for (int j = warp; j < (BM / 16) * (r / 16); j += LAT_WARPS) {
      const int rt = j / (r / 16);
      const int ct = j % (r / 16);
      float* otile = Os + rt * 16 * LDO + ct * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, otile, LDO, wmma::mem_row_major);
      for (int kk = 0; kk < kt; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Ps + rt * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(vb, Kt + kk * 16 * LDK + ct * 16, LDK);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(otile, acc, LDO, wmma::mem_row_major);
    }
    if (STAGES == 2) __syncthreads();  // the buffer may be refilled
  }
  async_wait<0>();
  __syncthreads();  // O is final (or still zero) for every lane of the row

  if (f < R) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no live key -> 0
    bf16* dst = static_cast<bf16*>(a.out) + b * a.ob + (f % a.T) * a.ot +
                (long long)(f / a.T) * a.oh;
    for (int d = 2 * sub; d < r; d += 2 * LPR) {
      *reinterpret_cast<__nv_bfloat162*>(dst + d) =
          __floats2bfloat162_rn(orow[d] * inv, orow[d + 1] * inv);
    }
  }
}

template <int BM, typename KV, int STAGES>
__global__ void __launch_bounds__(LAT_THREADS)
latent_fwd(const LatentArgs a) {
  latent_body<BM, KV, STAGES>(a);
}

template <int BM, typename KV, int STAGES>
cudaError_t latent_launch(const LatentArgs& a, int B, cudaStream_t stream) {
  const int bytes = latent_smem_bytes(BM, a.C, a.r, a.tn, STAGES);
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  static std::atomic<int> raised[64];
  cudaError_t err =
      raise_smem_limit(latent_fwd<BM, KV, STAGES>, bytes, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.H * a.T + BM - 1) / BM, B);
  latent_fwd<BM, KV, STAGES><<<grid, LAT_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// What every C entry point does: check the sizes, pick the row block, launch
// on `stream`. Returns a cudaError_t.
template <typename KV, int STAGES>
int latent_entry(const LatentArgs* a, int B, int BM, void* stream) {
  if (a == nullptr || B < 0 || a->T < 0 || a->H <= 0 || a->C <= 0 ||
      a->C % 16 != 0 || a->r <= 0 || a->r % 16 != 0 || a->r > a->C ||
      a->tn <= 0 || a->tn % 16 != 0 || a->S < 0) {
    return cudaErrorInvalidValue;
  }
  if (sizeof(KV) == 1 && a->kv_scale == nullptr) return cudaErrorInvalidValue;
  if ((a->page_table == nullptr || a->NP <= 0 || a->P <= 0 ||
                a->page <= 0 || a->S != a->NP * a->page)) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || a->T == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (BM) {
    case 16:
      return latent_launch<16, KV, STAGES>(*a, B, s);
    case 32:
      return latent_launch<32, KV, STAGES>(*a, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace lmc
