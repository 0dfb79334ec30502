"""Paged attention over the MLA latent cache (DeepSeek-V2/V3): the port of
``lmcache_tpu/ops/paged_latent_attention.py``.

The paged engine's arena (pages allocated on demand, shared prefixes,
preemption) over the latent cache: a page is ``[page_size, Cp]`` latent rows
with no head axis. The kernels are :mod:`~lmcache_tpu_torch.ops.latent_attention`'s
single-read MQA formulation over rows gathered through the page table:

- :func:`paged_latent_attention` / :func:`quantized_paged_latent_attention`:
  one page per step (``csrc/paged_latent_attention.cu``,
  ``latent_fwd<BM, KV, 1, true>``);
- :func:`paged_latent_attention_dma` /
  :func:`quantized_paged_latent_attention_dma`: tiles of several page slots
  with the next tile's loads in flight (``latent_fwd<BM, KV, 2, true>``). The
  names are the JAX package's; on the GPU the "dma" is ``cp.async``.

Shapes: ``q_full [B, T, H, C]``; ``latent_pool [P, page, Cp]`` (one layer of
the arena, read in place) with ``Cp >= C``: the kernels and the plain
versions read the first C columns of a row, the same function as the JAX
entry points, which zero-pad the query to Cp (the arena's pad columns are
zero); int8 arenas carry fp32 scale pools ``[P, page]``; ``page_table int32
[B, NP]``; ``q_offset``/``kv_len int32 [B]``. Page-table entries past a
sequence's live pages may be any id: they are masked, not read. Out
``[B, T, H, rank]``.

CUDA tensors go to the kernels, which raise on what they do not take; CPU
tensors go to the plain versions. A query that sees no key gives 0 on both
(the JAX ``*_reference`` functions average the values uniformly there, as
the plain versions here do unless ``zero_dead_rows``). Each entry point
counts its kernel launches in ``.launches`` ("prefill" for T > 1, "decode"
for T == 1).
"""

from collections import Counter

import torch

from lmcache_tpu_torch.ops import latent_attention as _lat
from lmcache_tpu_torch.ops.latent_attention import latent_attention_reference

STREAM_TILE_MAX = 128  # most keys per tile of the streaming kernel


def _gather(pool, page_table, C):
    """[P, page, Cp] arena -> [B, NP * page, C] rows of each sequence."""
    B, NP = page_table.shape
    page = pool.shape[1]
    return pool[page_table.long()][..., :C].reshape(B, NP * page, C)


def paged_latent_attention_reference(q_full, latent_pool, page_table,
                                     q_offset, kv_len, *, rank, scale,
                                     zero_dead_rows=False) -> torch.Tensor:
    """Gather the pages densely, then
    :func:`~lmcache_tpu_torch.ops.latent_attention.latent_attention_reference`
    (fp32): the plain version of :func:`paged_latent_attention` and
    :func:`paged_latent_attention_dma`."""
    lat = _gather(latent_pool, page_table, q_full.shape[3])
    return latent_attention_reference(q_full, lat, q_offset, kv_len,
                                      rank=rank, scale=scale,
                                      zero_dead_rows=zero_dead_rows)


def quantized_paged_latent_attention_reference(q_full, sym_pool, scale_pool,
                                               page_table, q_offset, kv_len,
                                               *, rank, scale,
                                               zero_dead_rows=False
                                               ) -> torch.Tensor:
    """Dequantize the gathered pages to fp32, then dense latent attention:
    the plain version of the two int8 entry points."""
    B, NP = page_table.shape
    page = sym_pool.shape[1]
    sym = _gather(sym_pool, page_table, q_full.shape[3]).float()
    s = scale_pool[page_table.long()].reshape(B, NP * page)
    return latent_attention_reference(q_full, sym * s[..., None], q_offset,
                                      kv_len, rank=rank, scale=scale,
                                      zero_dead_rows=zero_dead_rows)


def stream_tile(BM: int, C: int, rank: int, page: int) -> int:
    """Keys per tile of the streaming kernel: the most (a multiple of 16, at
    most ``STREAM_TILE_MAX``) whose two buffers fit shared memory, cut to
    whole pages where a page is smaller (and a multiple of 16)."""
    for tn in range(STREAM_TILE_MAX, 0, -16):
        if _lat.smem_bytes(BM, C, rank, tn, 2) <= _lat._SMEM_LIMIT:
            return tn // page * page if tn >= page and page % 16 == 0 else tn
    raise ValueError(f"latent width {C} (rank {rank}) leaves no room for a "
                     f"double-buffered tile")


def _paged(wrapper, stream, q_full, pool, scales, page_table, q_offset,
           kv_len, rank, scale):
    if q_full.device.type == "cpu":
        if scales is None:
            return paged_latent_attention_reference(
                q_full, pool, page_table, q_offset, kv_len, rank=rank,
                scale=scale, zero_dead_rows=True)
        return quantized_paged_latent_attention_reference(
            q_full, pool, scales, page_table, q_offset, kv_len, rank=rank,
            scale=scale, zero_dead_rows=True)
    if q_full.device.type != "cuda":
        raise ValueError(f"unsupported device {q_full.device}")
    B, T, H, C = q_full.shape
    _lat.check_cuda_args(q_full, pool, scales, q_offset, kv_len, rank, B)
    if (page_table.device != q_full.device or page_table.dtype != torch.int32
            or page_table.dim() != 2 or page_table.shape[0] != B
            or not page_table.is_contiguous()):
        raise ValueError(f"page_table must be contiguous int32 [{B}, NP] on "
                         f"{q_full.device}")
    P, page = pool.shape[:2]
    NP = page_table.shape[1]
    if stream:
        BM = _lat.row_block(H, T, C, rank, 16, 2)
        tn = stream_tile(BM, C, rank, page)
    else:
        if page % 16:
            raise ValueError(f"page size {page} must be a multiple of 16")
        tn = page
        BM = _lat.row_block(H, T, C, rank, tn, 1)
    out = torch.empty((B, T, H, rank), dtype=q_full.dtype,
                      device=q_full.device)
    a = _lat.fill_args(q_full, pool, scales, out, q_offset, kv_len, scale,
                       tn, NP * page)
    a.page_table = page_table.data_ptr()
    a.NP, a.P, a.page = NP, P, page
    name = ("lmc_paged_latent_stream_attention_" if stream
            else "lmc_paged_latent_attention_")
    _lat.launch(wrapper, "paged_latent_attention",
                name + ("bf16" if scales is None else "int8"), a, q_full, BM)
    return out


def paged_latent_attention(q_full, latent_pool, page_table, q_offset, kv_len,
                           *, rank: int, scale: float) -> torch.Tensor:
    """Absorbed-MLA attention over a paged latent arena, one page per step;
    see the module docstring. On CUDA tensors: ``latent_fwd<BM, bf16, 1,
    true>`` (bf16, page a multiple of 16, at most what one block's shared
    memory holds: 128 at C = 576); on CPU tensors
    :func:`paged_latent_attention_reference`."""
    return _paged(paged_latent_attention, False, q_full, latent_pool, None,
                  page_table, q_offset, kv_len, rank, scale)


def quantized_paged_latent_attention(q_full, sym_pool, scale_pool,
                                     page_table, q_offset, kv_len, *,
                                     rank: int, scale: float) -> torch.Tensor:
    """:func:`paged_latent_attention` over an int8 arena (symbols
    ``[P, page, Cp]``, fp32 scales ``[P, page]``). On CUDA tensors:
    ``latent_fwd<BM, int8, 1, true>``."""
    return _paged(quantized_paged_latent_attention, False, q_full, sym_pool,
                  scale_pool, page_table, q_offset, kv_len, rank, scale)


def paged_latent_attention_dma(q_full, latent_pool, page_table, q_offset,
                               kv_len, *, rank: int,
                               scale: float) -> torch.Tensor:
    """:func:`paged_latent_attention` with the live page slots streamed in
    tiles of up to 128 keys, the next tile in flight; same contract, any
    page size. On CUDA tensors: ``latent_fwd<BM, bf16, 2, true>``."""
    return _paged(paged_latent_attention_dma, True, q_full, latent_pool,
                  None, page_table, q_offset, kv_len, rank, scale)


def quantized_paged_latent_attention_dma(q_full, sym_pool, scale_pool,
                                         page_table, q_offset, kv_len, *,
                                         rank: int,
                                         scale: float) -> torch.Tensor:
    """:func:`quantized_paged_latent_attention` with streamed tiles. On CUDA
    tensors: ``latent_fwd<BM, int8, 2, true>``."""
    return _paged(quantized_paged_latent_attention_dma, True, q_full,
                  sym_pool, scale_pool, page_table, q_offset, kv_len, rank,
                  scale)


for _entry in (paged_latent_attention, quantized_paged_latent_attention,
               paged_latent_attention_dma,
               quantized_paged_latent_attention_dma):
    _entry.launches = Counter()
del _entry
