"""Serde factory (a port of ``lmcache_tpu/storage/serde/__init__.py``;
reference: lmcache/storage_backend/serde/__init__.py:19-41).

Supported serde names:
- ``raw`` (alias ``fast``): lossless self-describing binary container
- ``cachegen``: lossy CacheGen codec (quantization, then range coding on the
  card or with the host C++ coder)

``raw_zstd`` and ``safetensors`` are not ported yet (ROADMAP, module item
8) and raise ``NotImplementedError``.
"""

from typing import Tuple

from lmcache_tpu_torch.config import (GlobalConfig, LMCacheEngineConfig,
                                      LMCacheEngineMetadata)
from lmcache_tpu_torch.storage.serde.raw_serde import (RawDeserializer,
                                                       RawSerializer)
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
    elif serde_type in ("raw_zstd", "safetensors", "safetensor"):
        raise NotImplementedError(
            f"serde {serde_type!r} is not ported yet (ROADMAP, module item "
            f"8)")
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
