// The argument block of the MLA latent-attention kernels (rows 8, 9 and 10:
// latent_attention.cu, paged_latent_attention.cu), mirrored on the host by
// a ctypes.Structure with the same fields in the same order
// (ops/latent_attention.py::LatentArgs). The contract and the body are in
// latent_sm90.cuh.

#pragma once

#include "paged_common.cuh"

namespace lmc {

// strides in elements
struct LatentArgs {
  const void* q;           // [B, T, H, C] bf16
  const void* kv;          // dense [B, S, >= C] or paged [P, page, >= C]
  void* out;               // [B, T, H, r] bf16 (unused by a split launch)
  const float* kv_scale;   // int8: dense [B, S] or paged [P, page]
  const int* page_table;   // paged: [B, NP]
  const int* q_offset;
  const int* kv_len;
  float* part_o;           // split: fp32 partials [B, nsplit, T * H, r]
  float* part_ml;          // split: fp32 (m, l) [B, nsplit, T * H, 2]
  int T, H, C, r;
  int S;                   // keys a sequence can hold (paged: NP * page)
  int NP, P, page;         // paged only
  int box;                 // paged: rows a TMA box (divides tile and page)
  int split;               // keys a split, a multiple of the tile; 0: none
  float scale;
  // q and out [B, T, H]; rows: kb the batch (dense) or page (paged) stride,
  // ks the row stride; scales: sb, ss likewise
  long long qb, qt, qh, kb, ks, ob, ot, oh, sb, ss;
};

}  // namespace lmc
