"""Storage backend interface.

Capability parity with reference
lmcache/storage_backend/abstract_backend.py:12-121: put / contains / get plus
default batched variants. ``batched_get`` is a generator yielding results in
key order (``None`` on miss) so the caller can stop at the first miss —
the longest-contiguous-prefix retrieval contract.
"""

import abc
from typing import Iterable, Iterator, List, Optional, Tuple

from lmcache_tpu_torch.utils import CacheEngineKey


class LMCBackendInterface(metaclass=abc.ABCMeta):

    @abc.abstractmethod
    def put(self, key: CacheEngineKey, blob, blocking: bool = True) -> None:
        """Store one KV chunk blob. Non-blocking puts enqueue the write to a
        background worker and return immediately."""
        raise NotImplementedError

    @abc.abstractmethod
    def contains(self, key: CacheEngineKey) -> bool:
        raise NotImplementedError

    def batched_contains(self, keys: Iterable[CacheEngineKey]) -> List[bool]:
        """Existence of many keys in order. Remote-tier backends override
        this with a single MEXIST round trip; local tiers loop dict hits."""
        return [self.contains(k) for k in keys]

    def flush(self) -> None:
        """Wait for in-flight non-blocking puts to become durable.
        Backends with background put workers override this."""

    @abc.abstractmethod
    def get(self, key: CacheEngineKey):
        """Return the blob for key, or None on miss."""
        raise NotImplementedError

    def batched_put(
        self,
        keys_and_blobs: Iterable[Tuple[CacheEngineKey, object]],
        blocking: bool = True,
    ) -> int:
        nchunks = 0
        for key, blob in keys_and_blobs:
            self.put(key, blob, blocking=blocking)
            nchunks += 1
        return nchunks

    def batched_get(
        self,
        keys: Iterable[CacheEngineKey],
    ) -> Iterator[Optional[object]]:
        for key in keys:
            yield self.get(key) if self.contains(key) else None

    @abc.abstractmethod
    def close(self) -> None:
        """Release worker threads / sockets. Idempotent."""
        raise NotImplementedError
