// Absorbed multi-head latent attention over a paged latent arena, for
// Hopper (sm_90a): the two paged MLA kernels and row 10's key-split decode.
//
// Replaces the TPU kernels
// lmcache_tpu/ops/paged_latent_attention.py::_paged_latent_kernel (entry
// points paged_latent_attention and quantized_paged_latent_attention, row
// 9) and ::_paged_latent_dma_kernel (entry points paged_latent_attention_dma
// and quantized_paged_latent_attention_dma, row 10) as instantiations of the
// Hopper latent body of latent_sm90.cuh, which holds the contract, the
// design and every step: blocks of 64 (token, head) rows, a TMA ring of
// latent tiles read from the arena in place through the page table (a box a
// page piece and panel), S = Q K^T and O += P V as wgmma with S, P and O in
// registers, the two consumer warpgroups taking the tiles in turn.
// - Row 9, one page a step: the tile is one page (BN = page, a multiple of
//   16 up to what shared memory holds: 112 for bf16 and 80 for int8 rows),
//   the ring as many pages deep as fits.
// - Row 10, streamed: tiles of 32 keys across the page slots (any page
//   size: a tile is one box at pages that are multiples of 32, else
//   several pieces), the ring 4 tiles deep (int8: 3 and 2 staging).
// - Row 10's decode (launches of at most two row blocks, every decode step
//   at H <= 128): the keys split at absolute multiples of the wrapper's
//   split (a multiple of 32), one block a (row block, split, sequence)
//   writing fp32 partials, then the combine of combine.cuh. One block a
//   sequence walking all of its keys would leave B blocks on 132 SMs.
// Both walk the live page slots only (up to the block's causal limit and
// kv_len); page-table entries past them are never read, and a page id
// outside the pool reads as zeros. What carries over from the TPU kernels is
// the work per step, not their layout: the 128-lane pad of the arena (the
// TPU's DMA alignment) is not read, only the first C columns of a row.
//
// Bound on an H100: prefill by the operations (2 * H * (C + r) a live pair),
// decode at H = 16 by the latent bytes (~30 operations a byte).

#include "combine.cuh"
#include "latent_sm90.cuh"

namespace {

using lmc::LatentArgs;
using lmc::latent::Geometry;
using lmc::latent::launch;

constexpr int STREAM_TILE = 32;  // keys a tile of row 10

// row 9: the tile is the page
template <typename KV>
int launch_page_tiles(const LatentArgs* a, int B, void* stream) {
  if (a == nullptr) return cudaErrorInvalidValue;
  switch (a->page) {
    case 16:
      return launch<KV, true, 16>(a, B, 1, stream);
    case 32:
      return launch<KV, true, 32>(a, B, 1, stream);
    case 48:
      return launch<KV, true, 48>(a, B, 1, stream);
    case 64:
      return launch<KV, true, 64>(a, B, 1, stream);
    case 80:
      return launch<KV, true, 80>(a, B, 1, stream);
    case 96:
      return launch<KV, true, 96>(a, B, 1, stream);
    case 112:
      return launch<KV, true, 112>(a, B, 1, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// the largest page that row 9 takes: a tile of it fits shared memory
template <typename KV, int PAGE = 112>
constexpr int max_page() {
  if constexpr (PAGE < 16) {
    return 0;
  } else if constexpr (Geometry<KV, PAGE>::FITS) {
    return PAGE;
  } else {
    return max_page<KV, PAGE - 16>();
  }
}

}  // namespace

// Plain C entry points, bound with ctypes: the argument block (device
// pointers, strides in elements; box = the rows of a TMA box, dividing the
// tile and the page), the batch, the stream; they return a cudaError_t (0
// on success).

// row 9
extern "C" int lmc_paged_latent_attention_bf16(const LatentArgs* a, int B,
                                               void* stream) {
  return launch_page_tiles<lmc::bf16>(a, B, stream);
}

extern "C" int lmc_paged_latent_attention_int8(const LatentArgs* a, int B,
                                               void* stream) {
  return launch_page_tiles<lmc::i8>(a, B, stream);
}

// row 10: one split (a->split == 0, nsplit 1), or the split decode's first
// kernel (a->split keys a split, nsplit = max(1, ceil(S / split)), the
// partials in a->part_o and a->part_ml)
extern "C" int lmc_paged_latent_stream_attention_bf16(const LatentArgs* a,
                                                      int B, int nsplit,
                                                      void* stream) {
  return launch<lmc::bf16, true, STREAM_TILE>(a, B, nsplit, stream);
}

extern "C" int lmc_paged_latent_stream_attention_int8(const LatentArgs* a,
                                                      int B, int nsplit,
                                                      void* stream) {
  return launch<lmc::i8, true, STREAM_TILE>(a, B, nsplit, stream);
}

// row 10's split decode, second kernel: out [B, T, H, r] bf16 (strides ob,
// ot, oh in elements, unit along r) from the partials [B, nsplit, T * H, r]
// and [.., 2]
extern "C" int lmc_paged_latent_combine_partials(
    const void* part_o, const void* part_ml, void* out, int B, int T, int H,
    int r, int nsplit, long long ob, long long ot, long long oh,
    void* stream) {
  return lmc::split::launch_combine(part_o, part_ml, nullptr, out, B, T, H,
                                    1, r, nsplit, ob, ot, oh, stream);
}

// Sizes the wrapper needs: the keys of row 10's tile, and the largest page
// of row 9 (quant: int8 rows).
extern "C" int lmc_paged_latent_stream_tile() { return STREAM_TILE; }

extern "C" int lmc_paged_latent_max_page(int quant) {
  return quant ? max_page<lmc::i8>() : max_page<lmc::bf16>();
}
