"""Storage backend factory: the local tiers ("cuda" and "cpu") for now.
The disk, remote and hybrid tiers are ROADMAP module item 8."""

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
    logger.info("Creating local-only backend on %s", config.local_device)
    return LMCLocalBackend(config.local_device,
                           capacity_bytes=config.local_capacity_bytes)
