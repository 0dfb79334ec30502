"""Serving engine for Multi-head Latent Attention models: the port of
``lmcache_tpu/serving/mla_engine.py``.

The continuous-batching scheduler of :class:`ServingEngine` (admission,
prefill segments interleaved with batched decode, cache-tier reuse,
store-back) over ONE latent pool ``[L, B, S + 1, r + p]`` instead of the
per-head K/V pool: at DeepSeek-V2-Lite geometry a token costs 31.1 KB over
27 layers, against 276 KB of expanded K/V. Only the residence differs: this
class allocates the latent pool (``kv_dtype="native"`` in the model dtype,
``"int8"`` with one fp32 scale per token), runs ``mla.forward`` (which writes
the pool in place), and converts slots to and from the latent wire blobs
``[L, 1, T, 1, r + p]`` (an int8 pool quantizes what it injects and
dequantizes what it stores, so the wire stays the model-dtype latent).

CacheBlend ``context_chunks`` requests are healed by
:class:`lmcache_tpu_torch.blend_mla.MLACacheBlender` and injected as latent
wire blobs. ``decode_block > 1``, ``spec_lookahead`` (the verification is
a ``K + 1``-token ``mla.forward`` over every slot) and ``logprobs`` are the
scheduler's. On a ``mesh`` the latent pool is replicated over "model" (it
has no head axis) and its slots split over "data" as the dense engine's;
each rank's forward runs its query heads (``models/mla.py``).
"""

import torch

from lmcache_tpu_torch.models import mla
from lmcache_tpu_torch.serving.engine import ServingEngine


def new_mla_blender(eng):
    """The MLA blender of an MLA engine (dense or paged)."""
    from lmcache_tpu_torch.blend_mla import MLACacheBlender
    return MLACacheBlender(eng.cfg, eng.params, eng.cache_engine,
                           recompute_ratio=eng._blend_ratio, mesh=eng.mesh)


class MLAServingEngine(ServingEngine):

    def __init__(self, cfg: mla.MLAConfig, params, **kwargs):
        super().__init__(cfg, params, **kwargs)
        self._forward = mla.forward

    def _check_config(self, cfg) -> None:
        mla.check_supported(cfg)
        mla.model_axis(cfg, self.mesh)

    def _heads_split(self) -> bool:
        return False  # the latents are whole on every rank

    def _alloc_pool(self):
        new = (mla.new_quantized_latent_cache if self.kv_dtype == "int8"
               else mla.new_latent_cache)
        return new(self.cfg, self.B, self.S + self._write_horizon,
                   device=self.device, mesh=self.mesh)

    def _slot_view(self, slot: int):
        """One slot of the pool as a batch-1 pool (views; slot axis 1)."""
        b = self._local(slot)
        if self.kv_dtype == "int8":
            return {name: t[:, b:b + 1] for name, t in self.kv_pool.items()}
        return self.kv_pool[:, b:b + 1]

    _new_blender = new_mla_blender

    def _read_slot(self, slot: int, n: int) -> torch.Tensor:
        """Latent wire blob [L, 1, n, 1, C] of one slot: a VIEW of the pool,
        or for an int8 pool the dequantized latents (a new tensor)."""
        b = self._local(slot)
        if self.kv_dtype != "int8":
            return mla.cache_to_blob(self.kv_pool, b, n)
        return mla.quantized_cache_to_blob(self.kv_pool, b, n,
                                           mla.torch_dtype(self.cfg))

    def _inject(self, blob: torch.Tensor, slot: int, pos: int) -> None:
        """Write a latent wire blob into ``slot`` at token ``pos``, in place;
        an int8 pool quantizes it per token on the way in."""
        into = (mla.blob_into_quantized_cache if self.kv_dtype == "int8"
                else mla.blob_into_cache)
        into(self.kv_pool, blob, self._local(slot), pos)
