"""Native serving loop: continuous batching with KV-cache reuse, one
resident KV pool on the GPU, batched decode, per-request prefill with
cached-prefix skip, and non-blocking store-back into the cache tiers."""

from lmcache_tpu_torch.serving.request import (Request, RequestState,
                                               SamplingParams)
from lmcache_tpu_torch.serving.engine import ServingEngine

__all__ = ["Request", "RequestState", "SamplingParams", "ServingEngine"]
