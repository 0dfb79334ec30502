"""Device mesh, sharding rules and ring attention over ``torch.distributed``:
the port of ``lmcache_tpu/parallel``."""

from lmcache_tpu_torch.parallel.mesh import (MeshConfig, kv_blob_sharding,
                                             kv_cache_sharding,
                                             latent_cache_sharding,
                                             local_shape, make_mesh,
                                             paged_kv_sharding,
                                             shard_blob_slice, shard_params)
from lmcache_tpu_torch.parallel.ring_attention import ring_attention

__all__ = [
    "MeshConfig",
    "make_mesh",
    "shard_params",
    "kv_cache_sharding",
    "latent_cache_sharding",
    "paged_kv_sharding",
    "kv_blob_sharding",
    "local_shape",
    "shard_blob_slice",
    "ring_attention",
]
