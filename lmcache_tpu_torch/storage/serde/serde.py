"""Serializer / deserializer interfaces and debug wrappers (a copy of
``lmcache_tpu/storage/serde/serde.py``).

Capability parity with reference lmcache/storage_backend/serde/serde.py:12-72:
an abstract (to_bytes / from_bytes) pair plus composable timing wrappers that
log MB and ms per call when debug mode is on.
"""

import abc

from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.utils import Timer

logger = init_logger(__name__)


class Serializer(metaclass=abc.ABCMeta):

    @abc.abstractmethod
    def to_bytes(self, blob) -> bytes:
        """Serialize a KV blob (torch tensor or numpy array) to bytes,
        including all metadata (shape, dtype) needed to reconstruct it."""
        raise NotImplementedError


class Deserializer(metaclass=abc.ABCMeta):

    @abc.abstractmethod
    def from_bytes(self, bs: bytes):
        """Deserialize bytes back to a KV blob tensor."""
        raise NotImplementedError


class SerializerDebugWrapper(Serializer):

    def __init__(self, serializer: Serializer):
        self._serializer = serializer

    def to_bytes(self, blob) -> bytes:
        with Timer() as t:
            bs = self._serializer.to_bytes(blob)
        logger.debug("Serialized %.2f MB in %.2f ms",
                     len(bs) / 1e6, t.ms)
        return bs


class DeserializerDebugWrapper(Deserializer):

    def __init__(self, deserializer: Deserializer):
        self._deserializer = deserializer

    def from_bytes(self, bs: bytes):
        with Timer() as t:
            blob = self._deserializer.from_bytes(bs)
        logger.debug("Deserialized %.2f MB in %.2f ms",
                     len(bs) / 1e6, t.ms)
        return blob
