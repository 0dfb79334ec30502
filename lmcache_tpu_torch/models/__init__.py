"""Model families served by the port's engines: dense llama and MLA
(DeepSeek-V2/V3, :mod:`lmcache_tpu_torch.models.mla`), each over dense slots
or a shared page arena."""

from lmcache_tpu_torch.models.llama import (LlamaConfig, blob_into_cache,
                                            cache_to_blob, forward,
                                            init_params, new_kv_cache,
                                            paged_pool_from_jax,
                                            params_from_jax)
from lmcache_tpu_torch.models.mla import MLAConfig
from lmcache_tpu_torch.models.paged import (PageAllocator, forward_paged,
                                            forward_paged_quantized,
                                            new_paged_kv_pool,
                                            new_quantized_paged_pool,
                                            pages_needed)

__all__ = [
    "LlamaConfig", "init_params", "params_from_jax", "paged_pool_from_jax",
    "forward", "new_kv_cache", "cache_to_blob", "blob_into_cache",
    "PageAllocator", "pages_needed", "new_paged_kv_pool",
    "new_quantized_paged_pool", "forward_paged", "forward_paged_quantized",
    "MLAConfig"
]
