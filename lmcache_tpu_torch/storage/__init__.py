"""Storage backend factory (a port of ``lmcache_tpu/storage/__init__.py``;
reference lmcache/storage_backend/__init__.py:13-44): the config's local
tier ("cuda", "cpu" or a disk directory), its remote tier (plain or
pipelined), or both behind the hybrid backend."""

from lmcache_tpu_torch.config import LMCacheEngineConfig, LMCacheEngineMetadata
from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.storage.abstract_backend import LMCBackendInterface
from lmcache_tpu_torch.storage.local_backend import (LMCLocalBackend,
                                                     LMCLocalDiskBackend)

logger = init_logger(__name__)

__all__ = [
    "LMCBackendInterface",
    "CreateStorageBackend",
]


def _create_local(config: LMCacheEngineConfig) -> LMCBackendInterface:
    device = config.local_device
    if device in ("cuda", "cpu"):
        return LMCLocalBackend(device,
                               capacity_bytes=config.local_capacity_bytes)
    return LMCLocalDiskBackend(device)


def _create_remote(config: LMCacheEngineConfig,
                   metadata: LMCacheEngineMetadata) -> LMCBackendInterface:
    from lmcache_tpu_torch.storage.remote_backend import (
        LMCPipelinedRemoteBackend, LMCRemoteBackend)
    cls = (LMCPipelinedRemoteBackend if config.pipelined_backend
           else LMCRemoteBackend)
    logger.info("Creating %s for %s", cls.__name__, config.remote_url)
    return cls(config, metadata)


def CreateStorageBackend(
    config: LMCacheEngineConfig,
    metadata: LMCacheEngineMetadata,
) -> LMCBackendInterface:
    if config.remote_url is None:
        logger.info("Creating local-only backend on %s", config.local_device)
        return _create_local(config)
    if config.local_device is None:
        return _create_remote(config, metadata)
    from lmcache_tpu_torch.storage.hybrid_backend import LMCHybridBackend
    logger.info("Creating hybrid backend: local %s + %s",
                config.local_device, config.remote_url)
    return LMCHybridBackend(_create_local(config),
                            _create_remote(config, metadata), metadata,
                            config=config)
