"""Native serving loop: continuous batching with KV-cache reuse, one
resident KV pool on the GPU (dense slots, or a shared page arena), batched
decode, per-request prefill with cached-prefix skip, and non-blocking
store-back into the cache tiers."""

from lmcache_tpu_torch.serving.request import (Request, RequestState,
                                               SamplingParams)
from lmcache_tpu_torch.serving.engine import ServingEngine
from lmcache_tpu_torch.serving.paged_engine import PagedServingEngine

__all__ = ["Request", "RequestState", "SamplingParams", "ServingEngine",
           "PagedServingEngine"]
