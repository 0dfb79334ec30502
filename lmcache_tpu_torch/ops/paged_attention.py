"""Paged attention: decode/prefill over a page-table-indexed KV arena.

The port of ``lmcache_tpu/ops/paged_attention.py``. Four entry points with
the JAX signatures (the names are the JAX package's), all on the Hopper
body of the dense kernels (``csrc/flash_sm90.cuh``: TMA, wgmma, S, P and O
in registers) with the arena as its tile source, read in place through the
page table (a TMA box a page piece of :func:`box_rows` rows); launches of
at most ``DECODE_ROWS`` rows T * G (:func:`takes_split`, every decode step)
run the paged key-split decode, partials over splits of ``SPLIT_KEYS`` keys
of the table's ``NP * page`` slots (``attention.n_splits``), then the dense
kernels' combine (:func:`~lmcache_tpu_torch.ops.attention.combine_partials`):

- :func:`paged_attention` (row 4) and :func:`paged_attention_dma` (row 6),
  bf16 arenas (plain versions of the split
  :func:`paged_split_partials_reference` and
  :func:`paged_split_attention_reference`). ``paged_attention`` keeps row
  1's ring of 2 stages (``csrc/paged_attention.cu``, head dims 64, 96, 128,
  256), ``paged_attention_dma`` the deepest ring that fits, as row 2 does
  (``csrc/paged_stream_attention.cu``, head dims 64, 128, 256);
- :func:`quantized_paged_attention` (row 5) and
  :func:`quantized_paged_attention_dma` (row 7), int8 arenas, in the same
  two sources and head dims: row 3's int8 body (the pieces land in a
  staging ring and are converted exactly to bf16 on the chip, each key's
  scales read through the page table; int8 tiles of :func:`tile_keys`
  ``(D, quant=True)`` keys) and the int8 paged split (plain versions
  :func:`quantized_paged_split_partials_reference` and
  :func:`quantized_paged_split_attention_reference`).

Layouts: ``q [B, T, H, D]``; pools ``[P, H_kv, page, D]`` (head-major pages;
any strides with unit stride along D, so a layer's slice of the arena is read
in place); int8 arenas carry fp32 scale pools ``[P, page]``, one scale per
(page, token) shared by all heads; ``page_table int32 [B, NP]``;
``q_offset``/``kv_len int32 [B]``. Query ``t`` of sequence ``b`` sees key
positions ``kpos <= min(q_offset[b] + t, kv_len[b] - 1)`` and, with
``sliding_window=W``, ``kpos > q_offset[b] + t - W`` (``window_kind=
"sliding"``) or ``kpos // W == (q_offset[b] + t) // W`` (``"chunked"``,
Llama-4). ``logit_softcap`` bounds the scores by ``cap * tanh(s / cap)``
before the mask (Gemma-2); ``sinks`` ([H] fp32) joins per-head sink logits
to the softmax normalization (GPT-OSS): on the card the prefill body joins
them at its end, the split decode at the combine. Page-table entries past a
sequence's live pages may be any id: they are masked, not read.

A query that sees no key (``kv_len == 0``, or a window with no live key)
gives 0, on the card and on the CPU alike; the JAX ``*_reference`` functions
average V uniformly there and the Pallas kernels give 0.
``forward_paged`` never passes such a row.

CUDA tensors go to the kernels, which raise on what they do not take; CPU
tensors go to the plain versions (:func:`paged_attention_reference`,
:func:`quantized_paged_attention_reference`). Each entry point counts its
kernel launches in ``.launches`` ("prefill" for T > 1, "decode" for T == 1,
with "+window", "+softcap" and "+sinks" appended under those options; a
split decode once, and once under ``attention.combine_partials``).
"""

import math
from collections import Counter
from typing import Optional

import torch

from lmcache_tpu_torch.ops import attention as _attn
from lmcache_tpu_torch.ops.attention import mha_reference

_GRID_HEAD_DIMS = (64, 96, 128, 256)
_STREAM_HEAD_DIMS = (64, 128, 256)


def tile_keys(D: int, quant: bool = False) -> int:
    """Keys a tile of the Hopper body (``csrc/flash_sm90.cuh``,
    ``Geometry::BN``): over a bf16 arena 128, and 64 at D 256, where O
    alone takes 128 registers a thread; over an int8 arena 128 at D 64 and
    96, else 16 KB of symbols a side (64 at D 128, 32 at D 256), so that
    four staging stages fit beside two bf16 stages."""
    if quant:
        return 128 if D <= 96 else 8192 // D
    return 64 if D == 256 else 128


def box_rows(D: int, page: int, quant: bool = False) -> int:
    """Rows of one TMA box of the body: the largest divisor of its tile
    that also divides the page, so that a box never crosses a page (a
    multiple of 16, as pages are; an int8 box of 16 rows of at least 64
    bytes meets TMA's alignment)."""
    return math.gcd(tile_keys(D, quant), page)


def takes_split(T: int, G: int) -> bool:
    """Whether a launch of T tokens of a group of G query heads runs the
    key-split decode (every decode step of tinyllama, G 8, and Phi-3, G 1)
    rather than the prefill body."""
    return T * G <= _attn.DECODE_ROWS


def _gather_pages(pool, page_table):
    """[P, H_kv, page, D] pool -> token-major [B, NP*page, H_kv, D]."""
    B, NP = page_table.shape
    _, Hkv, page, D = pool.shape
    return pool[page_table.long()].permute(0, 1, 3, 2, 4).reshape(
        B, NP * page, Hkv, D)


def paged_attention_reference(q, k_pool, v_pool, page_table, q_offset,
                              kv_len, sliding_window=None, sm_scale=None,
                              logit_softcap=None, window_kind="sliding",
                              sinks=None) -> torch.Tensor:
    """Gather the pages densely, then dense attention: the plain version of
    :func:`paged_attention` and :func:`paged_attention_dma`, with the
    options of :func:`~lmcache_tpu_torch.ops.attention.mha_reference`."""
    _attn.check_options(q, sliding_window, window_kind, logit_softcap,
                        sinks, None, True)
    return mha_reference(q, _gather_pages(k_pool, page_table),
                         _gather_pages(v_pool, page_table), q_offset, kv_len,
                         sm_scale=sm_scale, sliding_window=sliding_window,
                         zero_dead_rows=True, logit_softcap=logit_softcap,
                         window_kind=window_kind, sinks=sinks)


def quantized_paged_attention_reference(q, k_sym_pool, v_sym_pool,
                                        k_scale_pool, v_scale_pool,
                                        page_table, q_offset, kv_len,
                                        sliding_window=None, sm_scale=None,
                                        logit_softcap=None,
                                        window_kind="sliding",
                                        sinks=None) -> torch.Tensor:
    """Dequantize the pages densely, then dense attention: the plain version
    of the two int8 entry points, with the same options."""
    _attn.check_options(q, sliding_window, window_kind, logit_softcap,
                        sinks, None, True)
    return mha_reference(q, _dequantize_pages(k_sym_pool, k_scale_pool,
                                              page_table),
                         _dequantize_pages(v_sym_pool, v_scale_pool,
                                           page_table),
                         q_offset, kv_len, sm_scale=sm_scale,
                         sliding_window=sliding_window, zero_dead_rows=True,
                         logit_softcap=logit_softcap, window_kind=window_kind,
                         sinks=sinks)


def _dequantize_pages(sym_pool, scale_pool, page_table, kv_len=None):
    """int8 [P, H_kv, page, D] pool and its [P, page] scales -> fp32
    token-major [B, NP*page, H_kv, D]; with ``kv_len`` the scales at and
    past it are selected to 0 first, as the kernels' are (so NaN there
    stays out)."""
    B, NP = page_table.shape
    s = scale_pool[page_table.long()].reshape(B, NP * sym_pool.shape[2])
    if kv_len is not None:
        kpos = torch.arange(s.shape[1], device=s.device)
        s = torch.where(kpos[None] < kv_len.to(s.device)[:, None], s,
                        torch.zeros((), device=s.device))
    return _gather_pages(sym_pool, page_table).float() * s[:, :, None, None]


def paged_split_partials_reference(q, k_pool, v_pool, page_table, q_offset,
                                   kv_len, sliding_window=None,
                                   sm_scale=None, window_kind="sliding",
                                   logit_softcap=None):
    """Plain version of the paged split decode's first kernel: the pages
    gathered densely, then
    :func:`~lmcache_tpu_torch.ops.attention.split_partials_reference` over
    the table's ``NP * page`` slots. Returns fp32 ``part_o [B, H_kv, n, R,
    D]`` and ``part_ml [B, H_kv, n, R, 2]`` with ``n =
    attention.n_splits(NP * page)`` and R = T * G rows (token,
    head-in-group) token-major; a split with no live key of a row gives it
    ``m = -1e30, l = 0, O = 0``. The window (sliding or chunked) and the
    softcap act on the scores; sinks join at the combine."""
    return _attn.split_partials_reference(
        q, _gather_pages(k_pool, page_table), _gather_pages(v_pool, page_table),
        q_offset, kv_len, sm_scale=sm_scale, sliding_window=sliding_window,
        window_kind=window_kind, logit_softcap=logit_softcap)


def paged_split_attention_reference(q, k_pool, v_pool, page_table, q_offset,
                                    kv_len, sliding_window=None,
                                    sm_scale=None, window_kind="sliding",
                                    logit_softcap=None, sinks=None):
    """The plain split-then-combine of the paged decode:
    :func:`paged_split_partials_reference`, then
    :func:`~lmcache_tpu_torch.ops.attention.combine_partials_reference`;
    fp32 ``[B, T, H, D]``, 0 for a row that sees no key. Equal to
    :func:`paged_attention_reference` up to fp32 rounding."""
    part_o, part_ml = paged_split_partials_reference(
        q, k_pool, v_pool, page_table, q_offset, kv_len,
        sliding_window=sliding_window, sm_scale=sm_scale,
        window_kind=window_kind, logit_softcap=logit_softcap)
    return _attn.combine_partials_reference(
        part_o, part_ml, q.shape[1], q.shape[2] // k_pool.shape[1],
        sinks=sinks)


def quantized_paged_split_partials_reference(q, k_sym_pool, v_sym_pool,
                                             k_scale_pool, v_scale_pool,
                                             page_table, q_offset, kv_len,
                                             sliding_window=None,
                                             sm_scale=None,
                                             window_kind="sliding",
                                             logit_softcap=None):
    """Plain version of the int8 paged split decode's first kernel: the
    pages dequantized densely to fp32, then
    :func:`~lmcache_tpu_torch.ops.attention.split_partials_reference` over
    the table's ``NP * page`` slots (shapes as
    :func:`paged_split_partials_reference`). Where the kernel multiplies a
    score by its key's K scale and P by its key's V scale (after the row
    sum), this multiplies the symbols first: the same function. As the
    kernel gives a key outside its split's live range scale 0, the scales
    at and past ``kv_len`` are 0 here, so that NaN there stays out."""
    return _attn.split_partials_reference(
        q, _dequantize_pages(k_sym_pool, k_scale_pool, page_table, kv_len),
        _dequantize_pages(v_sym_pool, v_scale_pool, page_table, kv_len),
        q_offset, kv_len, sm_scale=sm_scale, sliding_window=sliding_window,
        window_kind=window_kind, logit_softcap=logit_softcap)


def quantized_paged_split_attention_reference(q, k_sym_pool, v_sym_pool,
                                              k_scale_pool, v_scale_pool,
                                              page_table, q_offset, kv_len,
                                              sliding_window=None,
                                              sm_scale=None,
                                              window_kind="sliding",
                                              logit_softcap=None, sinks=None):
    """The plain split-then-combine of the int8 paged decode:
    :func:`quantized_paged_split_partials_reference`, then
    :func:`~lmcache_tpu_torch.ops.attention.combine_partials_reference`;
    fp32 ``[B, T, H, D]``, 0 for a row that sees no key. Equal to
    :func:`quantized_paged_attention_reference` up to fp32 rounding."""
    part_o, part_ml = quantized_paged_split_partials_reference(
        q, k_sym_pool, v_sym_pool, k_scale_pool, v_scale_pool, page_table,
        q_offset, kv_len, sliding_window=sliding_window, sm_scale=sm_scale,
        window_kind=window_kind, logit_softcap=logit_softcap)
    return _attn.combine_partials_reference(
        part_o, part_ml, q.shape[1], q.shape[2] // k_sym_pool.shape[1],
        sinks=sinks)


# ------------------------------------------------------------ the kernels ---


def _check_cuda_args(q, k_pool, v_pool, k_scale, v_scale, page_table,
                     q_offset, kv_len, head_dims):
    """Raise on what the kernels cannot take: devices, dtypes, shapes,
    strides and alignment (16-byte loads along D)."""
    dev = q.device
    quant = k_scale is not None
    named = [("k_pool", k_pool), ("v_pool", v_pool),
             ("page_table", page_table), ("q_offset", q_offset),
             ("kv_len", kv_len)]
    if quant:
        named += [("k_scale_pool", k_scale), ("v_scale_pool", v_scale)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be [B, T, H, D] and the "
                         f"pools {tuple(k_pool.shape)} [P, H_kv, page, D]")
    B, _, H, D = q.shape
    P, Hkv, page, Dk = k_pool.shape
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} and v_pool "
                         f"{tuple(v_pool.shape)} differ")
    if Dk != D or Hkv <= 0 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit the pools "
                         f"{tuple(k_pool.shape)}: H must be a multiple of "
                         f"H_kv and the head dims equal")
    if D not in head_dims:
        raise ValueError(f"head dim {D} not supported by this kernel "
                         f"(one of {head_dims})")
    if page % 16:
        raise ValueError(f"page size {page} must be a multiple of 16")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bfloat16 queries; q is "
                         f"{q.dtype}")
    pool_dtype = torch.int8 if quant else torch.bfloat16
    vec = 16 if quant else 8  # elements per 16-byte load
    for name, t, dt, n in (("q", q, torch.bfloat16, 8),
                           ("k_pool", k_pool, pool_dtype, vec),
                           ("v_pool", v_pool, pool_dtype, vec)):
        if t.dtype != dt:
            raise ValueError(f"the CUDA kernel takes {dt} here; {name} is "
                             f"{t.dtype}")
        if t.stride(-1) != 1 or any(s % n for s in t.stride()[:-1]):
            raise ValueError(f"{name} needs unit stride along D and the "
                             f"other strides a multiple of {n}: {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if quant:
        for name, t in (("k_scale_pool", k_scale), ("v_scale_pool", v_scale)):
            if (t.dtype != torch.float32 or t.shape != (P, page)
                    or t.stride(1) != 1):
                raise ValueError(f"{name} must be float32 [{P}, {page}] with "
                                 f"unit stride along the page: "
                                 f"{t.dtype} {tuple(t.shape)} {t.stride()}")
    if (page_table.dtype != torch.int32 or page_table.dim() != 2
            or page_table.shape[0] != B or not page_table.is_contiguous()):
        raise ValueError(f"page_table must be contiguous int32 [{B}, NP]")
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{B}]")


def _launch(entry, lib, q, k_pool, v_pool, k_scale, v_scale, page_table,
            q_offset, kv_len, sliding_window, sm_scale, logit_softcap,
            window_kind, sinks):
    """Rows 4-7 (arguments checked): the Hopper body of ``lib`` over the
    arena (int8 where ``k_scale`` is given) or, at most ``DECODE_ROWS``
    rows, its split decode and the dense kernels' combine (which joins the
    sinks), with the window, the softcap and the sinks in the argument
    block."""
    B, T, H, D = q.shape
    P, Hkv, page, _ = k_pool.shape
    NP = page_table.shape[1]
    quant = k_scale is not None
    kind = "int8" if quant else "bf16"
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    # the pool's head-major strides are the page's, the head's and the row
    # in page's, the scale pools' [P, page] strides the page's and the row
    # in page's; its key count is the table's width
    a, _, _ = _attn.fill_args(q, k_pool, v_pool, out, q_offset, kv_len, True,
                              sm_scale, sliding_window, window_kind,
                              logit_softcap, sinks, k_scale=k_scale,
                              v_scale=v_scale)
    a.S = NP * page
    a.page_table = page_table.data_ptr()
    a.NP, a.P, a.page, a.box = NP, P, page, box_rows(D, page, quant)
    if takes_split(T, H // Hkv):
        _attn.split_decode(entry, _attn.split_entry(
            lib, f"lmc_{lib}_decode_split_{kind}"), a, q, Hkv, NP * page,
            sinks, out)
    else:
        _attn.launch(entry, _attn.load_entry(lib, f"lmc_{lib}_{kind}"), a, q,
                     Hkv)
    return out


def _dispatch(entry, stream_kernel, q, k_pool, v_pool, k_scale, v_scale,
              page_table, q_offset, kv_len, sliding_window, sm_scale,
              logit_softcap, window_kind, sinks):
    _attn.check_options(q, sliding_window, window_kind, logit_softcap,
                        sinks, None, True)
    opts = dict(sliding_window=sliding_window, sm_scale=sm_scale,
                logit_softcap=logit_softcap, window_kind=window_kind,
                sinks=sinks)
    if q.device.type == "cpu":
        if k_scale is None:
            return paged_attention_reference(
                q, k_pool, v_pool, page_table, q_offset, kv_len, **opts)
        return quantized_paged_attention_reference(
            q, k_pool, v_pool, k_scale, v_scale, page_table, q_offset,
            kv_len, **opts)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_args(q, k_pool, v_pool, k_scale, v_scale, page_table,
                     q_offset, kv_len,
                     _STREAM_HEAD_DIMS if stream_kernel else _GRID_HEAD_DIMS)
    lib = "paged_stream_attention" if stream_kernel else "paged_attention"
    return _launch(entry, lib, q, k_pool, v_pool, k_scale, v_scale,
                   page_table, q_offset, kv_len, sliding_window, sm_scale,
                   logit_softcap, window_kind, sinks)


def paged_attention(q, k_pool, v_pool, page_table, q_offset, kv_len, *,
                    sliding_window: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    logit_softcap: Optional[float] = None,
                    window_kind: str = "sliding",
                    sinks=None) -> torch.Tensor:
    """Attention over paged KV, one page per step on the TPU; see the
    module docstring.

    On CUDA tensors (bf16 q and pools, D of 64, 96, 128 or 256, page a
    multiple of 16): the Hopper body over the arena, or at most
    ``DECODE_ROWS`` rows the paged split decode and the combine; on CPU
    tensors :func:`paged_attention_reference`. A row with no live key
    gives 0.
    """
    return _dispatch(paged_attention, False, q, k_pool, v_pool, None, None,
                     page_table, q_offset, kv_len, sliding_window, sm_scale,
                     logit_softcap, window_kind, sinks)


def quantized_paged_attention(q, k_sym_pool, v_sym_pool, k_scale_pool,
                              v_scale_pool, page_table, q_offset, kv_len, *,
                              sliding_window: Optional[int] = None,
                              sm_scale: Optional[float] = None,
                              logit_softcap: Optional[float] = None,
                              window_kind: str = "sliding",
                              sinks=None) -> torch.Tensor:
    """:func:`paged_attention` over an int8 page arena: pages are read at
    half the bytes and converted exactly to bf16 on the chip, the per-token
    scales applied to the score and probability columns. On CUDA tensors
    (bf16 q, int8 pools, fp32 scale pools [P, page], D of 64, 96, 128 or
    256, page a multiple of 16): ``flash_sm90_fwd<D, 2, false, int8,
    true>`` over the arena, or at most ``DECODE_ROWS`` rows the int8 paged
    split decode and the combine; on CPU tensors
    :func:`quantized_paged_attention_reference`. A row with no live key
    gives 0."""
    return _dispatch(quantized_paged_attention, False, q, k_sym_pool,
                     v_sym_pool, k_scale_pool, v_scale_pool, page_table,
                     q_offset, kv_len, sliding_window, sm_scale,
                     logit_softcap, window_kind, sinks)


def paged_attention_dma(q, k_pool, v_pool, page_table, q_offset, kv_len, *,
                        sliding_window: Optional[int] = None,
                        sm_scale: Optional[float] = None,
                        logit_softcap: Optional[float] = None,
                        window_kind: str = "sliding",
                        sinks=None) -> torch.Tensor:
    """:func:`paged_attention` with the live pages streamed through a deeper
    ring; same contract, preferred for decode. On CUDA tensors (D of 64, 128
    or 256): the Hopper body over the arena at the deepest ring, or at most
    ``DECODE_ROWS`` rows the paged split decode and the combine."""
    return _dispatch(paged_attention_dma, True, q, k_pool, v_pool, None,
                     None, page_table, q_offset, kv_len, sliding_window,
                     sm_scale, logit_softcap, window_kind, sinks)


def quantized_paged_attention_dma(q, k_sym_pool, v_sym_pool, k_scale_pool,
                                  v_scale_pool, page_table, q_offset,
                                  kv_len, *,
                                  sliding_window: Optional[int] = None,
                                  sm_scale: Optional[float] = None,
                                  logit_softcap: Optional[float] = None,
                                  window_kind: str = "sliding",
                                  sinks=None) -> torch.Tensor:
    """:func:`quantized_paged_attention` with streamed tiles; same contract,
    preferred for decode. On CUDA tensors (D of 64, 128 or 256): the int8
    body over the arena, its staging ring as deep as shared memory holds,
    or at most ``DECODE_ROWS`` rows the int8 paged split decode and the
    combine."""
    return _dispatch(quantized_paged_attention_dma, True, q, k_sym_pool,
                     v_sym_pool, k_scale_pool, v_scale_pool, page_table,
                     q_offset, kv_len, sliding_window, sm_scale,
                     logit_softcap, window_kind, sinks)


for _entry in (paged_attention, quantized_paged_attention,
               paged_attention_dma, quantized_paged_attention_dma):
    _entry.launches = Counter()
del _entry
