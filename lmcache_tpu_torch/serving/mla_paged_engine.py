"""Paged serving engine for Multi-head Latent Attention models: the port of
``lmcache_tpu/serving/mla_paged_engine.py``.

:class:`PagedServingEngine`'s arena economics (pages allocated on demand,
admission backpressure, shared prefix pages, preemption into the cache
tiers) over the latent cache: a page is ``[page_size, Cp]`` latent rows with
no head axis (``Cp`` the lane-padded latent width of
``mla.latent_pad_dim``). The whole scheduler is inherited unchanged; this
class swaps the arena (``mla.new_paged_latent_pool``, or the int8 arena with
per-token scales), the forward (``mla.forward_paged``, which writes the pages
in place and reads them through ``paged_latent_attention_dma``) and the
page <-> wire-blob converters: wire blobs stay the model-dtype latent at the
logical width ``[L, 1, T, 1, r + p]``, so the pad is added on inject
(quantized there for an int8 arena) and stripped on read.

CacheBlend ``context_chunks`` requests are healed by
:class:`lmcache_tpu_torch.blend_mla.MLACacheBlender` and scattered onto
whole pages as the dense-KV paged engine does. ``decode_block > 1``,
``spec_lookahead`` (the verification is a ``K + 1``-token
``mla.forward_paged`` through the page tables) and ``logprobs`` are the
scheduler's. On a ``mesh`` the arena is replicated over both axes (every
rank writes the same latent rows) and each rank's forward runs its query
heads (``models/mla.py``).
"""

from typing import List

import torch

from lmcache_tpu_torch.models import mla
from lmcache_tpu_torch.serving.mla_engine import new_mla_blender
from lmcache_tpu_torch.serving.paged_engine import PagedServingEngine


class MLAPagedServingEngine(PagedServingEngine):

    def __init__(self, cfg: mla.MLAConfig, params, **kwargs):
        super().__init__(cfg, params, **kwargs)
        self._forward = mla.forward_paged

    def _check_config(self, cfg) -> None:
        mla.check_supported(cfg)
        mla.model_axis(cfg, self.mesh)

    def _heads_split(self) -> bool:
        return False  # the latents are whole on every rank

    def _alloc_arena(self):
        new = (mla.new_quantized_paged_latent_pool if self.kv_dtype == "int8"
               else mla.new_paged_latent_pool)
        return new(self.cfg, self.num_pages, self.page_size,
                   device=self.device)

    _new_blender = new_mla_blender

    def _inject_pages(self, blob: torch.Tensor, pages: List[int]) -> None:
        """Write a latent wire blob [L, 1, n*page, 1, C] onto whole pages,
        in place: lane-padded, and quantized per token for an int8 arena."""
        L, _, _, _, C = blob.shape
        ids = self._page_ids(pages)
        paged = mla.pad_latents(self.cfg, blob.to(self.device)[:, 0, :, 0, :]
                                .reshape(L, len(pages), self.page_size, C))
        if self.kv_dtype == "int8":
            sym, scl = mla.quantize_latents(paged)
            self.kv_pool["sym"][:, ids] = sym
            self.kv_pool["scale"][:, ids] = scl
            return
        self.kv_pool[:, ids] = paged.to(self.kv_pool.dtype)

    def _read_pages(self, pages: List[int]) -> torch.Tensor:
        """Gather whole pages into a latent wire blob [L, 1, n*page, 1, C]
        (dequantized for an int8 arena, the lane pad stripped): a COPY."""
        ids = self._page_ids(pages)
        if self.kv_dtype == "int8":
            g = mla.dequantize_latents(self.kv_pool["sym"][:, ids],
                                       self.kv_pool["scale"][:, ids],
                                       mla.torch_dtype(self.cfg))
        else:
            g = self.kv_pool[:, ids]
        L, n, pg, _ = g.shape
        g = g[..., :self.cfg.latent_dim].reshape(L, n * pg, -1)
        return g[:, None, :, None, :]
