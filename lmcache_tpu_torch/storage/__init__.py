"""Storage backend factory: a local tier ("cuda" or "cpu") or the remote
tier (a cache server at ``remote_url``). The disk and hybrid tiers are
ROADMAP module item 8."""

from lmcache_tpu_torch.config import LMCacheEngineConfig, LMCacheEngineMetadata
from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.storage.abstract_backend import LMCBackendInterface
from lmcache_tpu_torch.storage.local_backend import LMCLocalBackend

logger = init_logger(__name__)

__all__ = [
    "LMCBackendInterface",
    "CreateStorageBackend",
]


def CreateStorageBackend(
    config: LMCacheEngineConfig,
    metadata: LMCacheEngineMetadata,
) -> LMCBackendInterface:
    """The tier the config names (the config refuses the disk and hybrid
    tiers, which are not ported yet)."""
    if config.remote_url is None:
        logger.info("Creating local-only backend on %s", config.local_device)
        return LMCLocalBackend(config.local_device,
                               capacity_bytes=config.local_capacity_bytes)
    from lmcache_tpu_torch.storage.remote_backend import (
        LMCPipelinedRemoteBackend, LMCRemoteBackend)
    cls = (LMCPipelinedRemoteBackend if config.pipelined_backend
           else LMCRemoteBackend)
    logger.info("Creating %s for %s", cls.__name__, config.remote_url)
    return cls(config, metadata)
