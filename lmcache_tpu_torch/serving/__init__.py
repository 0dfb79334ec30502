"""Native serving loop: continuous batching with KV-cache reuse, one
resident KV pool on the GPU (dense slots, or a shared page arena; for MLA
models a latent pool or a latent page arena), batched decode, per-request
prefill with cached-prefix skip, and non-blocking store-back into the cache
tiers."""

from lmcache_tpu_torch.serving.request import (Request, RequestState,
                                               SamplingParams)
from lmcache_tpu_torch.serving.engine import ServingEngine
from lmcache_tpu_torch.serving.paged_engine import PagedServingEngine
from lmcache_tpu_torch.serving.mla_engine import MLAServingEngine
from lmcache_tpu_torch.serving.mla_paged_engine import MLAPagedServingEngine

__all__ = ["Request", "RequestState", "SamplingParams", "ServingEngine",
           "PagedServingEngine", "MLAServingEngine", "MLAPagedServingEngine"]
