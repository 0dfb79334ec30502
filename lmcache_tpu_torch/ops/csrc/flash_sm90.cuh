// The Hopper prefill body of the dense attention kernels
// (flash_attention.cu, flash_stream_attention.cu): TMA, wgmma, and the
// scores, probabilities and output accumulator kept in registers.
//
// What the TPU kernels compute (lmcache_tpu/ops/attention.py::_flash_kernel
// and ::_flash_dma_kernel): for each (sequence, KV head, block of query
// rows), an online softmax over the causally live key blocks, S = Q K^T
// scaled (softcapped, masked by the causal limit, kv_len and the window),
// P = exp(S - m) rounded to bf16, O += P V, and at the end O / l with the
// attention sinks joined to l. The contract is that of flash_args.cuh.
//
// Design, per block of ROWS = 128 query rows, (token, head-in-group) pairs
// of one (sequence, KV head) flattened token-major (so every group size
// works, 5 included), three warpgroups:
// - warpgroup 2, the producer, gives its registers to the others
//   (setmaxnreg) and one of its threads keeps TMA loads of K and V tiles
//   of BN keys in flight through a ring of STAGES stages, with mbarrier
//   full and empty barriers. The tiles run from the one that holds the
//   window's first key to the causal limit, so dead tiles are neither read
//   nor computed.
// - warpgroups 0 and 1, the consumers, own 64 rows each. A consumer loads
//   its Q rows once with 16-byte loads (a block of 64 rows is 64 / G
//   tokens, not a TMA box when G is 5), then per tile runs S = Q K^T as
//   wgmma (A = Q and B = the K tile, both K-major in shared memory, fp32
//   accumulators in registers: a row lies in a quad of threads), the
//   online softmax on S in registers (masks, softcap and window are
//   selects; the row max and sum are reduced over the quad with shfl_xor 1
//   and 2), converts P to bf16 in registers and feeds it as wgmma's
//   register A operand into O += P V (B = the V tile, MN-major: the
//   transpose bit). O stays in registers, D / 2 fp32 a thread, and is
//   written once at the end, with the sink correction there.
// - Shared memory holds Q and the ring only. K, V and Q are stored in
//   panels of PW columns (64, or 32 at D = 96, whose 192-byte rows take a
//   64-byte swizzle), each row of a panel one swizzle atom wide: the TMA
//   maps' swizzle (128 or 64 bytes) and the wgmma descriptors' layout
//   agree by construction, and Q is written by hand in the same pattern.
// - TMA reads whole boxes: K/V rows at and past kend inside the pool are
//   loaded. Masked scores are selects, so K's tail is harmless, but
//   0 * NaN is NaN, so the consumers zero V's tail rows of the last tile in
//   shared memory before its PV product.
// - No float atomics and a fixed order of every sum: two launches on the
//   same inputs give the same bits.
// Tiles: BN = 128 keys at D 64, 96 and 128, 64 at D 256 (O alone takes 128
// registers a thread there). The overlap of the softmax with the next
// product and ping-pong between the consumers are left to a later
// revision.
//
// Bound on an H100: a prefill of T tokens over S keys does
// 4 * H * D * (live key pairs) operations on about 2 * (T*H*D + 2*S*H_kv*D)
// bytes, far above the card's ~295 FLOP/byte ridge: bound by the
// tensor-core operations, which wgmma is the one way to reach.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time

#include <utility>

#include "flash_args.cuh"

namespace lmc {
namespace sm90 {

constexpr int WG = 128;         // threads of a warpgroup
constexpr int CONSUMERS = 2;    // consumer warpgroups of 64 rows each
constexpr int ROWS = 64 * CONSUMERS;
constexpr int THREADS = WG * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

template <int D>
struct Geometry {
  static constexpr int BN = D == 256 ? 64 : 128;    // keys a tile
  static constexpr int PW = D % 64 == 0 ? 64 : 32;  // columns a panel
  static constexpr int SWB = 2 * PW;                // bytes a panel row
  static constexpr int PANELS = D / PW;
  static constexpr int LAYOUT = PW == 64 ? 1 : 2;   // wgmma: 128B / 64B
  static constexpr int SWZ_MASK = SWB / 16 - 1;
  static constexpr int Q_PANEL = 64 * SWB;          // a consumer's panel
  static constexpr int Q_WG = 64 * D * 2;           // a consumer's Q
  static constexpr int T_PANEL = BN * SWB;
  static constexpr int TILE = BN * D * 2;           // one K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int ALIGN = 1024;  // the swizzle pattern's period
  static constexpr int bytes(int stages) {
    return ALIGN + CONSUMERS * Q_WG + stages * (STAGE + 16);
  }
  static constexpr int max_stages() {
    return (SMEM_LIMIT - ALIGN - CONSUMERS * Q_WG) / (STAGE + 16);
  }
};

// The coordinate (1..3) of a 4-d K or V tensor map that carries the key,
// the KV head and the pool row: the host orders the three dimensions by
// stride, whatever the layout.
struct TmaOrder {
  int k[3];
  int v[3];
};

// ------------------------------------------------------------- PTX ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout (1: 128 B,
// 2: 64 B). Every panel starts on the 1024-byte period of the pattern, so
// the base offset stays 0; a step along K inside a swizzle atom moves the
// start address only.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared
// memory; accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
    : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared
// memory; accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
    : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32]: A in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// ------------------------------------------------------------ body ---

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax update of a thread's two rows over one tile of scores
// in registers, in the log2 domain (scores times log2 e, so that each
// exponent is one ex2): element i is row (i >> 1) & 1 of the thread's pair,
// key k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1); a row's max and sum are
// reduced over its quad of threads. MASK: the causal limit, kv_len and the
// window are selects on the scores, and a key masked so far gives 0.
// Leaves P (fp32) in sc, the rescale factors of O in alpha.
template <int BN, bool MASK, bool SOFTCAP>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const FlashArgs& a, int k0,
                                             int lane, const int (&qlim)[2],
                                             const int (&wlo)[2]) {
  const float scale2 = a.scale * LOG2E;
  const float cap2 = a.softcap * LOG2E;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int j = (i >> 1) & 1;
    float x = SOFTCAP ? cap2 * tanhf(sc[i] * a.scale / a.softcap)
                      : sc[i] * scale2;
    if (MASK) {
      const int kpos = k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
      x = kpos <= qlim[j] && kpos > wlo[j] ? x : NEG_INF;
    }
    sc[i] = x;
    mx[j] = fmaxf(mx[j], x);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    const float m_new = fmaxf(m[j], mx[j]);
    alpha[j] = ex2(m[j] - m_new);
    m[j] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int j = (i >> 1) & 1;
    const float p = !MASK || sc[i] > 0.5f * NEG_INF ? ex2(sc[i] - m[j])
                                                    : 0.f;
    sc[i] = p;
    sum[j] += p;  // the row sum before the bf16 rounding
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 1);
    sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 2);
    l[j] = alpha[j] * l[j] + sum[j];
  }
}

template <int D>
__device__ __forceinline__ int swizzle(int off) {
  return off ^ (((off >> 7) & Geometry<D>::SWZ_MASK) << 4);
}

// What a block works on: its rows, its sequence's limits, the keys
// [kbeg, kend) that some row of it can see (kbeg rounded down to a tile)
// and the consumers that own a live row.
struct Block {
  int f0, rows, qoff, klen, kbeg, kend, tiles, nlive, bkv;
};

template <int D>
__device__ __forceinline__ Block block_of(const FlashArgs& a) {
  constexpr int BN = Geometry<D>::BN;
  Block r;
  const int b = blockIdx.z;
  // the last rows have the most keys: schedule them first
  r.f0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  r.rows = a.T * a.G;
  r.qoff = a.q_offset[b];
  r.klen = min(a.kv_len[b], a.S);
  r.bkv = a.kv_slot != nullptr ? a.kv_slot[0] : b;
  const int t_last = min((r.f0 + ROWS - 1) / a.G, a.T - 1);
  r.kend = max(0, min(r.qoff + t_last + 1, r.klen));
  r.kbeg = window_start(a, r.qoff + r.f0 / a.G) / BN * BN;
  r.tiles = r.kend > r.kbeg ? (r.kend - r.kbeg + BN - 1) / BN : 0;
  r.nlive = r.rows - r.f0 > 64 ? 2 : 1;
  return r;
}

// A consumer's 64 Q rows into its panels (zero past the last row).
template <int D>
__device__ __forceinline__ void load_q(unsigned char* qs, const FlashArgs& a,
                                       int fw, int rows, int tid) {
  using Gm = Geometry<D>;
  const bf16* qbase = static_cast<const bf16*>(a.q) + blockIdx.z * a.qb +
                      static_cast<long long>(blockIdx.y) * a.G * a.qh;
  for (int i = tid; i < 64 * D / 8; i += WG) {
    const int rr = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int f = fw + rr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (f < rows) {
      val = *reinterpret_cast<const uint4*>(qbase + (f / a.G) * a.qt +
                                            (f % a.G) * a.qh + c);
    }
    *reinterpret_cast<uint4*>(
        qs + (c / Gm::PW) * Gm::Q_PANEL +
        swizzle<D>(rr * Gm::SWB + (c % Gm::PW) * 2)) = val;
  }
}

// K or V tile panel: pick the map coordinate that carries each index
__device__ __forceinline__ void tma_load_panel(const CUtensorMap* map,
                                               const int (&pos)[3],
                                               uint32_t dst, uint32_t bar,
                                               int col, int key, int head,
                                               int row) {
  auto at = [&](int i) {
    return pos[0] == i ? key : (pos[1] == i ? head : row);
  };
  tma_load_4d(dst, map, bar, col, at(1), at(2), at(3));
}

template <int D, int STAGES, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_sm90_fwd(const FlashArgs a, __grid_constant__ const CUtensorMap kmap,
                   __grid_constant__ const CUtensorMap vmap,
                   const TmaOrder ord) {
  using Gm = Geometry<D>;
  constexpr int BN = Gm::BN, PW = Gm::PW, PANELS = Gm::PANELS;
  extern __shared__ unsigned char smem_raw[];
  // 1024-aligned base: generic pointer and shared address
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + Gm::ALIGN - 1) & ~uint32_t(Gm::ALIGN - 1);
  unsigned char* gbase = smem_raw + (base - raw);
  constexpr int KV_OFF = CONSUMERS * Gm::Q_WG;
  constexpr int BAR_OFF = KV_OFF + STAGES * Gm::STAGE;
  auto k_stage = [&](int s) { return KV_OFF + s * Gm::STAGE; };
  auto v_stage = [&](int s) { return KV_OFF + s * Gm::STAGE + Gm::TILE; };
  auto full = [&](int s) { return base + BAR_OFF + 8 * s; };
  auto empty = [&](int s) { return base + BAR_OFF + 8 * (STAGES + s); };

  const Block blk = block_of<D>(a);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * blk.nlive);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * WG) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * WG) {
      for (int g = 0; g < blk.tiles; ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(empty(s), ((g / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), Gm::STAGE);
        const int k0 = blk.kbeg + g * BN;
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load_panel(&kmap, ord.k, base + k_stage(s) + p * Gm::T_PANEL,
                         full(s), p * PW, k0, blockIdx.y, blk.bkv);
          tma_load_panel(&vmap, ord.v, base + v_stage(s) + p * Gm::T_PANEL,
                         full(s), p * PW, k0, blockIdx.y, blk.bkv);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = threadIdx.x / WG;
  if (w >= blk.nlive) return;  // no live row
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int fw = blk.f0 + 64 * w;
  const uint32_t qw = base + w * Gm::Q_WG;
  load_q<D>(gbase + w * Gm::Q_WG, a, fw, blk.rows, tid);
  fence_async_smem();
  named_sync(1 + w, WG);

  // the thread's two rows (of the wgmma accumulator layout) and the keys
  // some row of this consumer sees
  int qlim[2], wlo[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = fw + warp * 16 + lane / 4 + 8 * j;
    const int qpos = blk.qoff + f / a.G;
    qlim[j] = f < blk.rows ? min(qpos, blk.klen - 1) : -1;
    wlo[j] = window_floor(a, qpos);
  }
  const int t_last = min((fw + 63) / a.G, a.T - 1);
  const int wkend = max(0, min(blk.qoff + t_last + 1, blk.klen));
  const int wkmin = window_start(a, blk.qoff + fw / a.G);
  // a tile needs no mask when it lies under every live row's causal limit
  // and above every live row's window floor
  const int wq_min = min(blk.qoff + fw / a.G, blk.klen - 1);
  const int wl_max = window_floor(a, blk.qoff + t_last);

  float o[PANELS][PW / 2];
#pragma unroll
  for (int p = 0; p < PANELS; ++p) {
#pragma unroll
    for (int i = 0; i < PW / 2; ++i) o[p][i] = 0.f;
  }
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int g = 0; g < blk.tiles; ++g) {
    const int s = g % STAGES;
    const int k0 = blk.kbeg + g * BN;
    mbar_wait(full(s), (g / STAGES) & 1);
    if (k0 + BN > blk.kend) {
      // the last tile: V rows at and past kend contribute exactly nothing
      constexpr int CHUNKS = PANELS * Gm::SWB / 16;
      const int first = blk.kend - k0;
      unsigned char* vs = gbase + v_stage(s);
      for (int i = w * WG + tid; i < (BN - first) * CHUNKS;
           i += WG * blk.nlive) {
        const int row = first + i / CHUNKS;
        const int c = i % CHUNKS;
        *reinterpret_cast<uint4*>(
            vs + (c / (Gm::SWB / 16)) * Gm::T_PANEL + row * Gm::SWB +
            (c % (Gm::SWB / 16)) * 16) = make_uint4(0, 0, 0, 0);
      }
      fence_async_smem();
      named_sync(3, WG * blk.nlive);
    }
    if (k0 < wkend && k0 + BN > wkmin) {
      // S = Q K^T
      float sc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk * 16 / PW;
        const int within = (kk * 16 % PW) * 2;
        const uint64_t da = smem_desc(qw + p * Gm::Q_PANEL + within, 16,
                                      8 * Gm::SWB, Gm::LAYOUT);
        const uint64_t db =
            smem_desc(base + k_stage(s) + p * Gm::T_PANEL + within, 16,
                      8 * Gm::SWB, Gm::LAYOUT);
        if constexpr (BN == 128) {
          wgmma_ss_n128(sc, da, db, kk > 0);
        } else {
          wgmma_ss_n64(sc, da, db, kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // online softmax on the registers; the mask only where some live row
      // of this consumer has a dead key in the tile
      float alpha[2];
      if (k0 + BN - 1 > wq_min || k0 <= wl_max) {
        softmax_tile<BN, true, SOFTCAP>(sc, m, l, alpha, a, k0, lane, qlim,
                                        wlo);
      } else {
        softmax_tile<BN, false, SOFTCAP>(sc, m, l, alpha, a, k0, lane, qlim,
                                         wlo);
      }
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
#pragma unroll
        for (int i = 0; i < PW / 2; ++i) o[p][i] *= alpha[(i >> 1) & 1];
      }
      // P in bf16 as wgmma's A fragments, 16 keys each: the accumulator
      // layout of two 8-key groups is the A layout of one 16-key step
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }
      }

      // O += P V
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PANELS; ++p) reg_fence(o[p]);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          const uint64_t db = smem_desc(
              base + v_stage(s) + p * Gm::T_PANEL + kk * 16 * Gm::SWB,
              8 * Gm::SWB, 8 * Gm::SWB, Gm::LAYOUT);
          if constexpr (PW == 64) {
            wgmma_rs_n64(o[p], pa[kk], db);
          } else {
            wgmma_rs_n32(o[p], pa[kk], db);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < PANELS; ++p) reg_fence(o[p]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // normalize and write. A sink logit joins the normalization and is then
  // dropped; with no live key m = -1e30 and l = 0, so the row gives 0.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = fw + warp * 16 + lane / 4 + 8 * j;
    if (f >= blk.rows) continue;
    const int head = blockIdx.y * a.G + f % a.G;
    float inv = l[j] > 0.f ? 1.f / l[j] : 0.f;
    if (a.sinks != nullptr) {  // m is in the log2 domain
      const float snk = a.sinks[head] * LOG2E;
      const float m2 = fmaxf(m[j], snk);
      const float keep = ex2(m[j] - m2);
      inv = keep / (l[j] * keep + ex2(snk - m2));
    }
    bf16* dst = static_cast<bf16*>(a.out) + blockIdx.z * a.ob +
                (f / a.G) * a.ot + static_cast<long long>(head) * a.oh;
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
#pragma unroll
      for (int c = 0; c < PW / 8; ++c) {
        const int i = 4 * c + 2 * j;
        *reinterpret_cast<__nv_bfloat162*>(dst + p * PW + c * 8 +
                                           2 * (lane & 3)) =
            __floats2bfloat162_rn(o[p][i] * inv, o[p][i + 1] * inv);
      }
    }
  }
}

// ------------------------------------------------------------ host ---

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// link against libcuda)
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// K or V as a 4-d tensor map: D innermost, then the key, head and pool-row
// dimensions in the order of their strides (elements), boxes of PW columns
// by BN keys in the body's swizzle. pos[i] receives the coordinate that
// carries index i (0 key, 1 head, 2 row). False where TMA cannot take the
// tensor (the wrapper checks alignment and strides first).
template <int D>
bool encode_kv_map(CUtensorMap* map, int (&pos)[3], const void* base,
                   long long s_key, long long s_head, long long s_row, int S,
                   int Hkv, unsigned long long rows) {
  using Gm = Geometry<D>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  struct Dim {
    cuuint64_t n;
    long long stride;
    int index;
  } d[3] = {{static_cast<cuuint64_t>(S > 1 ? S : 1), s_key, 0},
            {static_cast<cuuint64_t>(Hkv > 1 ? Hkv : 1), s_head, 1},
            {rows, s_row, 2}};
  for (int i = 1; i < 3; ++i) {
    for (int j = i; j > 0 && d[j - 1].stride > d[j].stride; --j) {
      std::swap(d[j - 1], d[j]);
    }
  }
  cuuint64_t dims[4] = {D, d[0].n, d[1].n, d[2].n};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {Gm::PW, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    if (d[i].stride < 0) return false;
    strides[i] = static_cast<cuuint64_t>(d[i].stride) * 2;
    pos[d[i].index] = i + 1;
    if (d[i].index == 0) box[i + 1] = Gm::BN;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Gm::PW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encode the launch's K and V maps and launch the body on `stream`. The
// pool's row count is not in the argument block: without kv_slot it is B;
// with it the row is the caller's word, read on the device, and the map's
// row dimension is left open.
template <int D, int STAGES, bool SOFTCAP>
cudaError_t launch(const FlashArgs& a, int B, int Hkv, cudaStream_t stream) {
  constexpr int bytes = Geometry<D>::bytes(STAGES);
  static_assert(bytes <= SMEM_LIMIT, "the ring does not fit shared memory");
  static std::atomic<int> raised[64];
  cudaError_t err =
      raise_smem_limit(flash_sm90_fwd<D, STAGES, SOFTCAP>, bytes, raised);
  if (err != cudaSuccess) return err;
  const unsigned long long rows =
      a.kv_slot != nullptr ? (1ull << 31) : static_cast<unsigned long long>(B);
  CUtensorMap kmap, vmap;
  TmaOrder ord;
  if (!encode_kv_map<D>(&kmap, ord.k, a.k, a.ks, a.kh, a.kb, a.S, Hkv,
                        rows) ||
      !encode_kv_map<D>(&vmap, ord.v, a.v, a.vs, a.vh, a.vb, a.S, Hkv,
                        rows)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((a.T * a.G + ROWS - 1) / ROWS, Hkv, B);
  flash_sm90_fwd<D, STAGES, SOFTCAP>
      <<<grid, THREADS, bytes, stream>>>(a, kmap, vmap, ord);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace lmc
