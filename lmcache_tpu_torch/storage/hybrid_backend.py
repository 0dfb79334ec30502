"""Hybrid (local + remote) backend.

Port of ``lmcache_tpu/storage/hybrid_backend.py`` (reference
lmcache/storage_backend/hybrid_backend.py:26-116): write-through puts,
read-through gets that fill the local tier, a ``batched_get`` that asks the
remote tier only for local misses, and a startup prefetch that warms the
local tier with the remote store's chunks of this deployment, newest
first, within ``hybrid_prefetch_chunks``, ``hybrid_prefetch_bytes`` and
``local_capacity_bytes``.

The remote tier's ``batched_get`` may yield undecoded CacheGen host chunks:
each is decoded to a blob (``kv.ensure_blob``; on the card one launch of
kernel row 11's fused entry) before the local tier takes it. With
``hybrid_prefetch_async`` the prefetch runs on a thread, which issues its
work on the CUDA stream that was current when the backend was built: reads
on that stream are ordered after it.
"""

import threading
from typing import Iterable, Iterator, List, Optional, Tuple

import torch

from lmcache_tpu_torch import kv
from lmcache_tpu_torch.config import LMCacheEngineConfig, LMCacheEngineMetadata
from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.storage.abstract_backend import LMCBackendInterface
from lmcache_tpu_torch.storage.remote_backend import LMCRemoteBackend
from lmcache_tpu_torch.utils import CacheEngineKey, _lmcache_trace_annotate

logger = init_logger(__name__)


class LMCHybridBackend(LMCBackendInterface):

    def __init__(self, local: LMCBackendInterface, remote: LMCRemoteBackend,
                 metadata: LMCacheEngineMetadata,
                 config: LMCacheEngineConfig):
        self.local = local
        self.remote = remote
        self.metadata = metadata
        self._prefetch_chunks = config.hybrid_prefetch_chunks
        self._prefetch_bytes = config.hybrid_prefetch_bytes
        cap = config.local_capacity_bytes
        if cap is not None:
            self._prefetch_bytes = min(self._prefetch_bytes or cap, cap)
        self._prefetch_thread: Optional[threading.Thread] = None
        if config.hybrid_prefetch_async:
            stream = (torch.cuda.current_stream()
                      if torch.cuda.is_available() else None)
            self._prefetch_thread = threading.Thread(
                target=self._prefetch_on, args=(stream, ),
                name="lmc-hybrid-prefetch", daemon=True)
            self._prefetch_thread.start()
        else:
            self._prefetch()

    def wait_prefetch(self) -> None:
        """Join an async startup prefetch (no-op when synchronous)."""
        if self._prefetch_thread is not None:
            self._prefetch_thread.join()
            self._prefetch_thread = None

    def _prefetch_on(self, stream) -> None:
        if stream is None:
            self._prefetch()
            return
        with torch.cuda.stream(stream):
            self._prefetch()

    def _prefetch(self) -> None:
        """Warm the local tier with this deployment's chunks already on the
        remote store, newest first, within the budgets."""
        if self._prefetch_chunks == 0:
            return
        meta = self.metadata
        matched = [
            key for key in self.remote.list()
            if key.model_name == meta.model_name
            and key.worker_id == meta.worker_id
            and key.world_size == meta.world_size
        ]
        if not matched:
            return
        total = len(matched)
        # the server lists keys in insertion order: the newest are the best
        # reuse candidates, so the budgets go to them
        matched = matched[::-1]
        if self._prefetch_chunks is not None:
            matched = matched[:self._prefetch_chunks]
        logger.info("Prefetching %d/%d chunks from the remote store",
                    len(matched), total)
        budget = self._prefetch_bytes
        fetched_bytes = 0
        for key, blob in zip(matched, self.remote.batched_get(matched)):
            if blob is None:
                continue
            blob = kv.ensure_blob(blob, meta.fmt)
            self.local.put(key, blob, blocking=True)
            fetched_bytes += blob.numel() * blob.element_size()
            if budget is not None and fetched_bytes >= budget:
                logger.info(
                    "Prefetch byte budget reached (%d bytes); remaining "
                    "chunks fill lazily on first use", fetched_bytes)
                break

    def contains(self, key: CacheEngineKey) -> bool:
        return self.local.contains(key) or self.remote.contains(key)

    def batched_contains(self, keys) -> List[bool]:
        key_list = list(keys)
        out = self.local.batched_contains(key_list)
        miss_idx = [i for i, hit in enumerate(out) if not hit]
        if miss_idx:
            remote_hits = self.remote.batched_contains(
                [key_list[i] for i in miss_idx])
            for i, hit in zip(miss_idx, remote_hits):
                out[i] = hit
        return out

    @_lmcache_trace_annotate
    def put(self, key: CacheEngineKey, blob, blocking: bool = True) -> None:
        # write-through: the local tier (the serving one) at once, the
        # remote one in the background unless the caller asks to wait
        self.local.put(key, blob, blocking=True)
        self.remote.put(key, blob, blocking=blocking)

    def batched_put(self, keys_and_blobs, blocking: bool = True) -> int:
        pairs = list(keys_and_blobs)
        for key, blob in pairs:
            self.local.put(key, blob, blocking=True)
        self.remote.batched_put(pairs, blocking=blocking)
        return len(pairs)

    @_lmcache_trace_annotate
    def get(self, key: CacheEngineKey):
        blob = self.local.get(key)
        if blob is not None:
            return blob
        blob = self.remote.get(key)
        if blob is not None:
            self.local.put(key, blob, blocking=False)  # read-through fill
        return blob

    def batched_get(
        self,
        keys: Iterable[CacheEngineKey],
    ) -> Iterator[Optional[object]]:
        key_list = list(keys)
        results: List[Optional[object]] = [None] * len(key_list)
        misses: List[Tuple[int, CacheEngineKey]] = []
        for idx, key in enumerate(key_list):
            blob = self.local.get(key)
            if blob is None:
                misses.append((idx, key))
            else:
                results[idx] = blob
        if misses:
            miss_keys = [key for _, key in misses]
            for (idx, key), blob in zip(misses,
                                        self.remote.batched_get(miss_keys)):
                if blob is not None:
                    blob = kv.ensure_blob(blob, self.metadata.fmt)
                    results[idx] = blob
                    self.local.put(key, blob, blocking=False)
        yield from results

    def flush(self) -> None:
        self.wait_prefetch()
        self.local.flush()
        self.remote.flush()

    def close(self) -> None:
        self.wait_prefetch()
        self.local.close()
        self.remote.close()
