"""lmcache_tpu_torch: the PyTorch/CUDA port of lmcache_tpu for NVIDIA Hopper.

Prefill a text once, then reuse its KV: chunked prefix hashing, a KV cache
tier in GPU memory (or host DRAM) or on a cache server shared by engine
instances (:mod:`lmcache_tpu_torch.server`, the raw or the CacheGen serde,
whose range coders are hand-written Hopper kernels), a dense llama-family
model whose attention is a hand-written Hopper flash-attention kernel, and
two continuous-batching serving engines: ``ServingEngine`` over dense slots
and ``PagedServingEngine`` over a shared bf16 or int8 page arena, read by
four hand-written Hopper paged-attention kernels. MLA models (DeepSeek-V2/V3,
``models/mla.py``) keep a latent cache instead, served by
``MLAServingEngine`` and ``MLAPagedServingEngine`` through hand-written
Hopper latent-attention kernels (dense and paged, bf16 and int8). Module names mirror
``lmcache_tpu``; this package imports neither JAX nor ``lmcache_tpu``. Entry
points run on ``"cuda"`` unless the caller passes ``device="cpu"``, and raise
when CUDA is absent otherwise.
"""

__version__ = "0.1.0"

from lmcache_tpu_torch.cache_engine import LMCacheEngine, LMCacheEngineBuilder
from lmcache_tpu_torch.config import (GlobalConfig, LMCacheEngineConfig,
                                      LMCacheEngineMetadata)

__all__ = [
    "LMCacheEngine",
    "LMCacheEngineBuilder",
    "LMCacheEngineConfig",
    "LMCacheEngineMetadata",
    "GlobalConfig",
    "__version__",
]
