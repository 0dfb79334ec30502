"""Serde factory (a port of ``lmcache_tpu/storage/serde/__init__.py``;
reference: lmcache/storage_backend/serde/__init__.py:19-41).

Supported serde names:
- ``raw`` (alias ``fast``): lossless self-describing binary container
- ``raw_zstd``: the same container with a zstd-compressed payload (needs
  ``zstandard``)
- ``safetensors`` (alias ``safetensor``): the safetensors container (needs
  ``safetensors``)
- ``cachegen``: lossy CacheGen codec (quantization, then range coding on the
  card or with the host C++ coder)
"""

from typing import Tuple

from lmcache_tpu_torch.config import (GlobalConfig, LMCacheEngineConfig,
                                      LMCacheEngineMetadata)
from lmcache_tpu_torch.storage.serde.raw_serde import (RawDeserializer,
                                                       RawSerializer)
from lmcache_tpu_torch.storage.serde.safe_serde import (SafeDeserializer,
                                                        SafeSerializer)
from lmcache_tpu_torch.storage.serde.serde import (Deserializer,
                                                   DeserializerDebugWrapper,
                                                   Serializer,
                                                   SerializerDebugWrapper)

__all__ = [
    "Serializer",
    "Deserializer",
    "CreateSerde",
]


def CreateSerde(
    serde_type: str,
    config: LMCacheEngineConfig,
    metadata: LMCacheEngineMetadata,
) -> Tuple[Serializer, Deserializer]:
    s: Serializer
    d: Deserializer

    if serde_type in ("raw", "fast"):
        s, d = RawSerializer(), RawDeserializer()
    elif serde_type == "raw_zstd":
        s, d = RawSerializer(compress_level=3), RawDeserializer()
    elif serde_type in ("safetensors", "safetensor"):
        s, d = SafeSerializer(), SafeDeserializer()
    elif serde_type == "cachegen":
        from lmcache_tpu_torch.storage.serde.cachegen_serde import (
            CacheGenDeserializer, CacheGenSerializer)
        s = CacheGenSerializer(config, metadata)
        d = CacheGenDeserializer(config, metadata)
    else:
        raise ValueError(f"Invalid serde type: {serde_type}")

    if GlobalConfig.is_debug():
        return SerializerDebugWrapper(s), DeserializerDebugWrapper(d)
    return s, d
