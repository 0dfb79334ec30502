"""Cache engine: token chunking, prefix hashing, store/retrieve orchestration.

Port of ``lmcache_tpu/cache_engine.py`` (reference lmcache/cache_engine.py:
16-437) over torch tensors:

- tokens are normalized to host numpy **once** per call,
- KV blobs are torch tensors (CUDA tier or CPU tier); chunk slicing makes
  views, and the storage tier keeps private copies of them, so a caller may
  store views of a KV pool it later overwrites,
- the retrieval contract is the JAX engine's: longest contiguous prefix of
  chunk hits, suffix-mask skip of already-computed tokens, partial
  first-chunk drop, and a returned boolean mask of retrieved positions.
"""

import time
from typing import Dict, Optional, Tuple, Union

import numpy as np

from lmcache_tpu_torch import kv, metrics
from lmcache_tpu_torch.chunks import prefix_chunk_hashes, tokens_to_numpy
from lmcache_tpu_torch.config import LMCacheEngineConfig, LMCacheEngineMetadata
from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.storage import CreateStorageBackend
from lmcache_tpu_torch.utils import CacheEngineKey, _lmcache_trace_annotate

logger = init_logger(__name__)


class LMCacheEngine:

    def __init__(self, config: LMCacheEngineConfig,
                 metadata: LMCacheEngineMetadata):
        self.config = config
        self.metadata = metadata
        self.chunk_size = config.chunk_size
        self.save_decode_cache = config.save_decode_cache
        self.engine_ = CreateStorageBackend(config, metadata)
        logger.debug("Storage backend: %s", type(self.engine_).__name__)

    # -- keys ---------------------------------------------------------------

    def _make_key(self, chunk_hash: str, fmt: str) -> CacheEngineKey:
        return CacheEngineKey(fmt, self.metadata.model_name,
                              self.metadata.world_size,
                              self.metadata.worker_id, chunk_hash)

    # -- store --------------------------------------------------------------

    @_lmcache_trace_annotate
    def store(
        self,
        tokens,
        kv_tensors,
        skip_existing: bool = True,
        blocking: bool = True,
    ) -> int:
        """Store the KV cache for ``tokens``.

        Args:
            tokens: 1-D token ids (numpy / list / tensor).
            kv_tensors: either the nested per-layer ((K, V), ...) tuples or a
                single [L, 2, ...] blob, in ``metadata.fmt`` layout, without
                a batch dimension.
            skip_existing: skip the longest already-cached chunk prefix.
            blocking: wait for writes to land before returning.

        Returns:
            the number of chunks written.
        """
        t0 = time.perf_counter()
        fmt = self.metadata.fmt
        tokens = tokens_to_numpy(tokens)

        blob = (kv_tensors if hasattr(kv_tensors, "ndim") else
                kv.tuple_to_blob(kv_tensors))
        n_tok = kv.num_tokens_in_blob(blob, fmt)
        if len(tokens) != n_tok:
            raise ValueError(
                f"tokens ({len(tokens)}) / kv ({n_tok}) length mismatch")

        chunk_hashes = prefix_chunk_hashes(tokens, self.chunk_size)

        start_chunk = 0
        if skip_existing:
            # one batched metadata round trip for the whole prefix (the
            # per-chunk contains() loop cost one remote RTT per chunk)
            hits = self.engine_.batched_contains(
                self._make_key(h, fmt) for h in chunk_hashes)
            for hit in hits:
                if not hit:
                    break
                start_chunk += 1

        chunk_blobs = kv.chunk_blob(blob, fmt, self.chunk_size,
                                    start=start_chunk * self.chunk_size)
        pairs = zip(chunk_hashes[start_chunk:], chunk_blobs)

        n_chunks = self.engine_.batched_put(
            ((self._make_key(h, fmt), chunk) for h, chunk in pairs),
            blocking=blocking,
        )
        dt = time.perf_counter() - t0
        metrics.inc("lmcache_chunks_stored", n_chunks)
        metrics.inc("lmcache_chunks_skipped", start_chunk)
        metrics.observe("lmcache_store_seconds", dt)
        logger.info("Stored %d chunks in %.1f ms", n_chunks, dt * 1e3)
        return n_chunks

    # -- retrieve -----------------------------------------------------------

    @_lmcache_trace_annotate
    def retrieve_stream(self, tokens, mask: Optional[np.ndarray] = None):
        """Stream the longest cached KV prefix chunk by chunk.

        Generator of ``(chunk_blob, start_tok, num_toks)`` — each chunk is
        yielded the moment its storage tier delivers it, so the caller can
        overlap device upload / partial prefill of chunk ``i`` with the
        fetch + decode of chunk ``i+1`` (the pipelined remote backend
        streams stage-wise; the reference — remote_backend.py:249-258 —
        could not hand chunks to the consumer before its whole batch was
        queued). Closing the generator early cancels in-flight fetches.

        ``start_tok`` is the chunk's first token position in ``tokens``;
        consecutive yields are contiguous. Terminates at the first miss.
        """
        fmt = self.metadata.fmt
        tokens = tokens_to_numpy(tokens)

        num_skip_tok = 0
        num_skip_chunk = 0
        if mask is not None:
            mask = np.asarray(mask, dtype=bool)
            num_skip_tok = int(len(mask) - mask.sum())
            num_skip_chunk = num_skip_tok // self.chunk_size

        chunk_hashes = prefix_chunk_hashes(tokens, self.chunk_size,
                                           num_skip_chunk)
        gen = self.engine_.batched_get(
            self._make_key(h, fmt) for h in chunk_hashes)
        pos = num_skip_chunk * self.chunk_size
        first = True
        try:
            for chunk in gen:
                if chunk is None:
                    break
                if first:
                    # drop tokens of the first chunk the caller already has
                    extra = num_skip_tok - num_skip_chunk * self.chunk_size
                    if extra:
                        chunk = kv.slice_blob_tokens(chunk, fmt, extra)
                        pos += extra
                    first = False
                n = kv.num_tokens_in_blob(chunk, fmt)
                yield chunk, pos, n
                pos += n
        finally:
            gen.close()  # cancel any in-flight pipelined fetches

    @_lmcache_trace_annotate
    def retrieve(
        self,
        tokens,
        mask: Optional[np.ndarray] = None,
        return_tuple: bool = True,
    ) -> Tuple[Union[kv.KVTuples, object], np.ndarray]:
        """Retrieve the longest cached KV prefix for ``tokens``.

        Args:
            tokens: 1-D token ids.
            mask: optional boolean suffix mask — False marks prefix tokens
                whose KV the caller already has (their chunks are skipped).
            return_tuple: return nested ((K, V), ...) tuples (reference
                contract); if False, return the single [L, 2, ...] blob,
                which is what the serving path consumes.

        Returns:
            (kv, ret_mask): kv is empty tuple / None when nothing was
            retrieved; ret_mask marks the token positions whose KV is
            contained in the returned cache.
        """
        t0 = time.perf_counter()
        fmt = self.metadata.fmt
        tokens = tokens_to_numpy(tokens)

        num_skip_tok = 0
        ret_mask = np.ones(len(tokens), dtype=bool)
        if mask is not None:
            num_skip_tok = int(len(mask) - np.asarray(mask,
                                                      dtype=bool).sum())
        ret_mask[:num_skip_tok] = False

        retrieved = [
            chunk for chunk, _, _ in self.retrieve_stream(tokens, mask)
        ]

        if not retrieved:
            ret_mask[:] = False
            metrics.inc("lmcache_retrieve_misses")
            return ((), ret_mask) if return_tuple else (None, ret_mask)

        blob = (retrieved[0] if len(retrieved) == 1 else
                kv.concat_blobs(retrieved, fmt))
        n_ret = kv.num_tokens_in_blob(blob, fmt)
        ret_mask[num_skip_tok + n_ret:] = False

        dt = time.perf_counter() - t0
        metrics.inc("lmcache_retrieve_hits")
        metrics.inc("lmcache_tokens_retrieved", n_ret)
        metrics.observe("lmcache_retrieve_seconds", dt)
        logger.info("Retrieved %d chunks (%d tokens) in %.1f ms",
                    len(retrieved), n_ret, dt * 1e3)
        if return_tuple:
            return kv.blob_to_tuple(blob), ret_mask
        return blob, ret_mask

    def lookup(self, tokens) -> int:
        """Number of leading tokens whose KV is already cached (hit length).

        Used by the scheduler to size partial prefill without moving data.
        """
        tokens = tokens_to_numpy(tokens)
        fmt = self.metadata.fmt
        n = 0
        hits = self.engine_.batched_contains(
            self._make_key(h, fmt)
            for h in prefix_chunk_hashes(tokens, self.chunk_size))
        for i, hit in enumerate(hits):
            if not hit:
                break
            n = min((i + 1) * self.chunk_size, len(tokens))
        return n

    def close(self) -> None:
        self.engine_.close()


class LMCacheEngineBuilder:
    """Per-instance-id singleton registry (reference:
    lmcache/cache_engine.py:387-436)."""

    _instances: Dict[str, LMCacheEngine] = {}
    _cfgs: Dict[str, LMCacheEngineConfig] = {}
    _metadatas: Dict[str, LMCacheEngineMetadata] = {}

    @classmethod
    def get_or_create(
        cls,
        instance_id: str,
        config: LMCacheEngineConfig,
        metadata: LMCacheEngineMetadata,
    ) -> LMCacheEngine:
        if instance_id not in cls._instances:
            engine = LMCacheEngine(config, metadata)
            cls._instances[instance_id] = engine
            cls._cfgs[instance_id] = config
            cls._metadatas[instance_id] = metadata
            return engine
        if (cls._cfgs[instance_id] != config
                or cls._metadatas[instance_id] != metadata):
            raise ValueError(
                f"Instance {instance_id} already exists with a different "
                f"configuration or metadata")
        return cls._instances[instance_id]

    @classmethod
    def get(cls, instance_id: str) -> Optional[LMCacheEngine]:
        return cls._instances.get(instance_id)

    @classmethod
    def destroy(cls, instance_id: str) -> None:
        engine = cls._instances.pop(instance_id, None)
        cls._cfgs.pop(instance_id, None)
        cls._metadatas.pop(instance_id, None)
        if engine is not None:
            engine.close()
