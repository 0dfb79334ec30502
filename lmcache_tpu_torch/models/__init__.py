"""Model families served by the port's engine (dense llama for now)."""

from lmcache_tpu_torch.models.llama import (LlamaConfig, blob_into_cache,
                                            cache_to_blob, forward,
                                            init_params, new_kv_cache,
                                            params_from_jax)

__all__ = [
    "LlamaConfig", "init_params", "params_from_jax", "forward",
    "new_kv_cache", "cache_to_blob", "blob_into_cache"
]
