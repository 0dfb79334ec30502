"""Paged KV arena + paged forward pass: the port of
``lmcache_tpu/models/paged.py``.

Dense slots (``llama.new_kv_cache``) reserve ``S_max`` tokens per sequence;
the paged arena shares one global pool of fixed-size pages across all
sequences and maps positions through per-sequence page tables, so device
memory is bounded by the tokens actually resident.

- the arena is one tensor ``[L, 2, P, H_kv, page, D]`` (head-major pages), or
  for int8 ``{"sym" int8 [L, 2, P, H_kv, page, D], "scale" f32
  [L, 2, P, page]}``; page 0 is the null page that padding page-table entries
  point at;
- :func:`forward_paged` / :func:`forward_paged_quantized` write the new
  tokens' K/V into the pages named by the page table **in place** (an
  ``index_put_`` on the layer's slice of the arena, on the current stream,
  before the attention launch; the JAX functions return a new arena) and
  attend through the paged-attention kernels of
  :mod:`lmcache_tpu_torch.ops.paged_attention`, which read the layer's slice
  in place;
- the kernel is chosen by head dim as in the JAX file: ``D % 128 == 0 or
  128 % D == 0`` takes the streaming (``_dma``) kernels, any other head dim
  the one-page-per-step kernels;
- each layer is ``llama.forward``'s (the same block structure, per-layer
  rope and query traits and MoE MLP) and attends under its own window,
  sliding or chunked, with the config's score softcap and attention sinks,
  so every ``LlamaConfig`` preset runs here.

Page size should divide the cache-engine chunk_size so retrieved chunks land
on whole pages.

With ``mesh`` (``lmcache_tpu_torch.parallel``) each rank keeps a local arena
of its ``H_kv / tp`` kv heads (``[L, 2, P, H_kv / tp, page, D]``; the int8
scales ``[L, 2, P, page]`` are head-free, a token's absmax taken over every
rank's heads) and runs the unchanged kernels on it: the JAX file's
``_shard_paged_attend``. The arena is the cross-request resource and has no
batch axis, so it is replicated over "data" and every data rank computes
every row of a step.
"""

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.ops import paged_attention as pa
from lmcache_tpu_torch.ops.quantized_attention import quantize_tokens
from lmcache_tpu_torch.parallel.mesh import (axis, local_shape,
                                             paged_kv_sharding)
from lmcache_tpu_torch.utils import resolve_device


def paged_pool_shape(cfg: llama.LlamaConfig, num_pages: int,
                     page_size: int, mesh=None) -> Tuple[int, ...]:
    """The shape of this rank's arena [L, 2, P, H_kv, page_size, D] on
    ``mesh`` (``parallel.paged_kv_sharding``): its kv heads on "model"."""
    return local_shape((cfg.n_layers, 2, num_pages, cfg.n_kv_heads,
                        page_size, cfg.head_dim), paged_kv_sharding(), mesh)


def new_paged_kv_pool(cfg: llama.LlamaConfig, num_pages: int, page_size: int,
                      device="cuda", mesh=None) -> torch.Tensor:
    """Global page arena [L, 2, P, H_kv, page_size, D], zeroed: HEAD-major
    pages, so the kernel reads a page of one head as one contiguous run. On
    ``mesh``, this rank's arena (:func:`paged_pool_shape`)."""
    return torch.zeros(paged_pool_shape(cfg, num_pages, page_size, mesh),
                       dtype=llama.torch_dtype(cfg),
                       device=resolve_device(device))


def new_quantized_paged_pool(cfg: llama.LlamaConfig, num_pages: int,
                             page_size: int, device="cuda",
                             mesh=None) -> Dict[str, torch.Tensor]:
    """Int8 page arena: {"sym" [L,2,P,H,page,D] i8, "scale" [L,2,P,page]
    f32, initialised to 1}. Half the bytes of the bf16 arena; read by the
    int8 paged kernels. Head-major pages like :func:`new_paged_kv_pool`
    (``mesh`` as there; the scales are head-free)."""
    dev = resolve_device(device)
    shape = paged_pool_shape(cfg, num_pages, page_size, mesh)
    return {
        "sym": torch.zeros(shape, dtype=torch.int8, device=dev),
        "scale": torch.ones(shape[:3] + shape[4:5], dtype=torch.float32,
                            device=dev),
    }


class PageAllocator:
    """Host-side refcounted free-list of page ids (page 0 is reserved as
    the null page that padding page-table entries point at).

    Refcounts enable prefix sharing: requests with a common prompt
    prefix reference the SAME physical pages (``share``); a page returns
    to the free list only when its last referent releases it. Shared
    prefix pages are immutable by construction (each request writes only
    at positions past its shared prefix), so no copy-on-write copy is
    ever needed.

    Arena-as-cache: freed pages keep their content and can be pulled
    back out of the free list by id (``reclaim``) as long as they have
    not been reallocated. ``alloc`` hands out the LEAST-recently-freed
    pages first so cached prefixes survive as long as possible."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        # insertion order == recycle order: alloc pops the FRONT (pages
        # never used / least-recently freed), free appends to the BACK.
        # All operations O(1) per page.
        self._free: "OrderedDict[int, None]" = OrderedDict(
            (p, None) for p in range(1, num_pages))
        self._rc: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged pool exhausted: want {n}, free {len(self._free)}")
        pages = [self._free.popitem(last=False)[0] for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    def share(self, pages: List[int]) -> None:
        """Take an additional reference on already-allocated pages."""
        for p in pages:
            if self._rc.get(p, 0) <= 0:
                raise ValueError(f"page {p} is not allocated")
            self._rc[p] += 1

    def reclaim(self, pages: List[int]) -> None:
        """Pull specific FREE pages back out of the free list (their
        content is intact: nothing was allocated over them)."""
        for p in pages:
            if self._rc.get(p, 0) > 0:
                raise ValueError(f"page {p} is live, use share()")
            del self._free[p]
            self._rc[p] = 1

    def free(self, pages: List[int]) -> List[int]:
        """Drop one reference per page; returns the pages that actually
        reached refcount 0 and went back to the free list."""
        freed = []
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"bad page id {p}")
            rc = self._rc.get(p, 1) - 1
            if rc <= 0:
                self._rc.pop(p, None)
                self._free[p] = None
                freed.append(p)
            else:
                self._rc[p] = rc
        return freed


def pages_needed(num_tokens: int, page_size: int) -> int:
    return -(-num_tokens // page_size)


def _streams(cfg: llama.LlamaConfig) -> bool:
    """Whether this head dim takes the streaming kernels (the JAX file's
    rule for its ``_dma`` kernels)."""
    D = cfg.head_dim
    return D % 128 == 0 or 128 % D == 0


def _paged_forward(params, cfg, tokens, start_pos, page_table, page, dev,
                   write_and_attend, last_logit_only, tp):
    """The layer loop shared by both arena dtypes, each layer under its own
    window and the config's softcap and sinks; ``write_and_attend(li, q, k,
    v, pidx, poff, table, start, kv_len, opts)`` scatters the new K/V into
    layer ``li`` of the arena and returns the attention output under the
    options ``opts`` (``llama._attention_options``). ``tp`` is the mesh's
    "model" axis."""
    B, T = tokens.shape
    start_pos = start_pos.to(device=dev, dtype=torch.int32)
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    positions = (start_pos[:, None] + torch.arange(
        T, device=dev, dtype=torch.int32)[None, :]).long()  # [B, T]
    kv_len = start_pos + T
    # per-(batch, new-token) page id and in-page offset
    pidx = torch.gather(table.long(), 1, positions // page)  # [B, T]
    poff = positions % page
    x = llama._embed(params, cfg, tokens.to(dev))
    lps = params["layers"]
    for li, window, g in llama._layer_plan(cfg):
        lp = {name: w[li] for name, w in lps.items()}
        q, k, v = llama._qkv_heads(llama._attn_input(x, lp, cfg), lp, cfg,
                                   positions, g, tp)
        attn = write_and_attend(li, q, k, v, pidx, poff, table, start_pos,
                                kv_len, llama._attention_options(cfg, lp,
                                                                 window, tp))
        x = llama._block(x, attn, lp, cfg, tp)
    if last_logit_only:
        x = x[:, -1:]
    return llama._lm_logits(x, params, cfg)


@torch.no_grad()
def forward_paged(
    params: llama.Params,
    cfg: llama.LlamaConfig,
    tokens: torch.Tensor,  # int [B, T]
    start_pos: torch.Tensor,  # int [B]
    kv_pool: torch.Tensor,  # [L, 2, P, H_kv, page, D] (head-major pages)
    page_table: torch.Tensor,  # int [B, NP]
    *,
    use_kernel: bool = True,
    last_logit_only: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`llama.forward` against the shared page arena.

    The new tokens' K/V is scattered **in place** into the pages named by
    ``page_table``; attention reads the pages through the page table inside
    the kernel. Returns (logits fp32, kv_pool). ``use_kernel=False`` (the
    JAX function's ``use_pallas=False``) computes attention with the plain
    version on whatever device the arena lives on. With ``mesh``,
    ``params`` are this rank's (``parallel.shard_params``) and ``kv_pool``
    its arena of ``H_kv / tp`` heads (every head where they do not divide
    "model"); the logits are the whole step's on every rank.
    """
    llama.check_supported(cfg)
    page = kv_pool.shape[4]
    if not use_kernel:
        impl = pa.paged_attention_reference
    elif _streams(cfg):
        impl = pa.paged_attention_dma
    else:
        impl = pa.paged_attention

    def write_and_attend(li, q, k, v, pidx, poff, table, start, kv_len,
                         opts):
        # pool[p, h, o] = kv[b, t, h] with (p, o) from the page table; idle
        # decode rows all land in the null page 0 (duplicate indices, order
        # undefined, masked)
        kp, vp = kv_pool[li, 0], kv_pool[li, 1]
        kp[pidx, :, poff] = k.to(kp.dtype)
        vp[pidx, :, poff] = v.to(vp.dtype)
        return impl(q, kp, vp, table, start, kv_len, **opts)

    logits = _paged_forward(params, cfg, tokens, start_pos, page_table, page,
                            kv_pool.device, write_and_attend,
                            last_logit_only, axis(mesh, "model"))
    return logits, kv_pool


@torch.no_grad()
def forward_paged_quantized(
    params: llama.Params,
    cfg: llama.LlamaConfig,
    tokens: torch.Tensor,  # int [B, T]
    start_pos: torch.Tensor,  # int [B]
    kv_pool: Dict[str, torch.Tensor],  # new_quantized_paged_pool()
    page_table: torch.Tensor,  # int [B, NP]
    *,
    use_kernel: bool = True,
    last_logit_only: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`forward_paged` over the int8 page arena: per-(layer, token)
    quantization on write, dequantization inside the kernel on read.
    ``mesh`` as in :func:`forward_paged`."""
    llama.check_supported(cfg)
    tp = axis(mesh, "model")
    sym_pool, scale_pool = kv_pool["sym"], kv_pool["scale"]
    page = sym_pool.shape[4]
    if not use_kernel:
        impl = pa.quantized_paged_attention_reference
    elif _streams(cfg):
        impl = pa.quantized_paged_attention_dma
    else:
        impl = pa.quantized_paged_attention

    def write_and_attend(li, q, k, v, pidx, poff, table, start, kv_len,
                         opts):
        absmax = llama.head_absmax(cfg, tp)
        k_sym, k_scale = quantize_tokens(k, (2, 3), absmax)  # [B,T,H,D]
        v_sym, v_scale = quantize_tokens(v, (2, 3), absmax)
        sym, scl = sym_pool[li], scale_pool[li]
        sym[0][pidx, :, poff] = k_sym
        sym[1][pidx, :, poff] = v_sym
        scl[0][pidx, poff] = k_scale
        scl[1][pidx, poff] = v_scale
        return impl(q, sym[0], sym[1], scl[0], scl[1], table, start, kv_len,
                    **opts)

    logits = _paged_forward(params, cfg, tokens, start_pos, page_table, page,
                            sym_pool.device, write_and_attend,
                            last_logit_only, tp)
    return logits, kv_pool
