"""Remote storage backend (and its pipelined variant) over the cache server.

Port of ``lmcache_tpu/storage/remote_backend.py`` (reference
lmcache/storage_backend/remote_backend.py:24-275): serde + connector, a
client-side cache of the remote key set, one MEXIST round trip for a batch
of keys, non-blocking puts finished by a single-worker executor, and a
pipelined ``batched_get`` that overlaps the network with parsing.

The tensors handed to ``put`` / ``batched_put`` may be views of a pool that
the caller updates in place and reuses (``ServingEngine._store_back``). A
non-blocking put therefore takes a private copy on the caller's thread and
CUDA stream before it returns; the worker makes its stream wait on a CUDA
event recorded after that copy before it quantizes.

With the ``cachegen`` serde, ``batched_get`` yields parsed but undecoded
host chunks (``CacheGenHostChunk``): the consumer decodes many of them in
one batch on the card (``serving/engine.py::_stream_inject``,
``kv.concat_blobs``).
"""

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional

import torch

from lmcache_tpu_torch import metrics
from lmcache_tpu_torch.config import LMCacheEngineConfig, LMCacheEngineMetadata
from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.storage.abstract_backend import LMCBackendInterface
from lmcache_tpu_torch.storage.connector import CreateConnector
from lmcache_tpu_torch.storage.serde import CreateSerde
from lmcache_tpu_torch.utils import CacheEngineKey, _lmcache_trace_annotate

logger = init_logger(__name__)


def _snapshot(blob):
    """A private contiguous copy of ``blob`` taken on the caller's stream,
    and (for a CUDA tensor) an event recorded after it."""
    blob = torch.as_tensor(blob)
    snap = torch.empty(blob.shape, dtype=blob.dtype, device=blob.device)
    snap.copy_(blob)
    ready = None
    if snap.is_cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(snap.device))
    return snap, ready


def _await_snapshot(snap, ready) -> None:
    """On the worker: order its stream after the snapshot's copy, and keep
    the snapshot's memory until the worker's kernels are done with it."""
    if ready is not None:
        stream = torch.cuda.current_stream(snap.device)
        stream.wait_event(ready)
        snap.record_stream(stream)


class LMCRemoteBackend(LMCBackendInterface):

    def __init__(self, config: LMCacheEngineConfig,
                 metadata: LMCacheEngineMetadata):
        self.config = config
        self.metadata = metadata
        self.connection = CreateConnector(config.remote_url)
        self.serializer, self.deserializer = CreateSerde(
            config.remote_serde or "raw", config, metadata)
        # host-phase deserializers (cachegen) let batched_get yield
        # undecoded host chunks, decoded downstream in batches
        self._host_phase = hasattr(self.deserializer, "from_bytes_host")
        self.existing_keys = set()
        self.lock = threading.Lock()
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="lmc-remote-put")
        self._pending: List[Future] = []
        self._pending_lock = threading.Lock()
        self._closed = False
        # warm the key index from the remote store (restart recovery)
        for key in self.list():
            self.existing_keys.add(key)

    def list(self) -> List[CacheEngineKey]:
        keys = []
        for key_str in self.connection.list():
            try:
                keys.append(CacheEngineKey.from_string(key_str))
            except ValueError:
                logger.warning("Ignoring malformed remote key %r", key_str)
        return keys

    def contains(self, key: CacheEngineKey) -> bool:
        with self.lock:
            if key in self.existing_keys:
                return True
        if self.connection.exists(key.to_string()):
            with self.lock:
                self.existing_keys.add(key)
            return True
        return False

    def batched_contains(self, keys) -> List[bool]:
        """All keys in ONE metadata round trip: client key-cache hits are
        answered locally, the rest ride a single MEXIST frame."""
        key_list = list(keys)
        out = [False] * len(key_list)
        ask, ask_idx = [], []
        with self.lock:
            for i, key in enumerate(key_list):
                if key in self.existing_keys:
                    out[i] = True
                else:
                    ask.append(key)
                    ask_idx.append(i)
        if ask:
            hits = self.connection.batched_exists(
                [k.to_string() for k in ask])
            with self.lock:
                for key, i, hit in zip(ask, ask_idx, hits):
                    if hit:
                        out[i] = True
                        self.existing_keys.add(key)
        return out

    def _submit(self, job, *args) -> None:
        with self._pending_lock:
            self._pending = [f for f in self._pending if not f.done()]
            self._pending.append(self._executor.submit(job, *args))

    @_lmcache_trace_annotate
    def put(self, key: CacheEngineKey, blob, blocking: bool = True) -> None:
        """Serialize and send one chunk. With ``blocking=False`` the caller
        may overwrite ``blob`` as soon as this returns."""
        if blocking:
            self._put_blocking(key, blob)
        else:
            self._submit(self._put_safe, key, *_snapshot(blob))

    def _put_safe(self, key: CacheEngineKey, snap, ready) -> None:
        try:
            _await_snapshot(snap, ready)
            self._put_blocking(key, snap)
        except Exception:
            logger.exception("Background remote put failed for %s",
                             key.to_string())

    def _put_blocking(self, key: CacheEngineKey, blob) -> None:
        t0 = time.perf_counter()
        bs = self.serializer.to_bytes(blob)
        self._send(key, bs)
        metrics.observe("lmcache_tier_put_seconds",
                        time.perf_counter() - t0, labels={"tier": "remote"})

    def _send(self, key: CacheEngineKey, bs: bytes) -> None:
        self.connection.set(key.to_string(), bs)
        with self.lock:
            self.existing_keys.add(key)

    def batched_put(self, keys_and_blobs, blocking: bool = True) -> int:
        """Serialize a whole store in one batch when the serde supports it
        (cachegen ``to_bytes_batch``: one quantization and one coder launch
        per half for all same-shape chunks), then send. With
        ``blocking=False`` the blobs are copied first and the whole batch is
        serialized and sent on the put worker."""
        pairs = list(keys_and_blobs)
        if len(pairs) <= 1 or not hasattr(self.serializer,
                                          "to_bytes_batch"):
            return super().batched_put(pairs, blocking=blocking)

        def job(pairs):
            t0 = time.perf_counter()
            bss = self.serializer.to_bytes_batch([b for _, b in pairs])
            for (key, _), bs in zip(pairs, bss):
                self._send(key, bs)
            metrics.observe("lmcache_tier_put_seconds",
                            time.perf_counter() - t0,
                            labels={"tier": "remote"})

        if blocking:
            job(pairs)
            return len(pairs)
        snaps = [(key, _snapshot(blob)) for key, blob in pairs]

        def job_safe():
            try:
                for _, (snap, ready) in snaps:
                    _await_snapshot(snap, ready)
                job([(key, snap) for key, (snap, _) in snaps])
            except Exception:
                logger.exception("Background batched put failed")

        self._submit(job_safe)
        return len(pairs)

    @_lmcache_trace_annotate
    def get(self, key: CacheEngineKey):
        t0 = time.perf_counter()
        bs = self.connection.get(key.to_string())
        if bs is None or len(bs) == 0:
            return None
        blob = self.deserializer.from_bytes(bs)
        metrics.observe("lmcache_tier_get_seconds",
                        time.perf_counter() - t0, labels={"tier": "remote"})
        return blob

    def _deserialize(self, bs):
        """A host chunk when the serde has a host phase, else a blob."""
        if self._host_phase:
            return self.deserializer.from_bytes_host(bs)
        return self.deserializer.from_bytes(bs)

    def batched_get(
        self,
        keys: Iterable[CacheEngineKey],
    ) -> Iterator[Optional[object]]:
        """One MEXIST round trip, then fetch and parse the hits in order
        (host chunks for the cachegen serde, see ``_deserialize``)."""
        key_list = list(keys)
        hits = self.batched_contains(key_list)
        for key, hit in zip(key_list, hits):
            if not hit:
                yield None
                continue
            bs = self.connection.get(key.to_string())
            yield self._deserialize(bs) if bs else None

    def flush(self) -> None:
        with self._pending_lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.flush()
        self._executor.shutdown(wait=True)
        self.connection.close()


class LMCPipelinedRemoteBackend(LMCRemoteBackend):
    """Streaming three-stage retrieval pipeline.

    Stage 1 (network thread) fetches raw bytes for the hit prefix only (one
    MEXIST round trip decides it); stage 2 (deserialize thread) parses them
    (for the cachegen serde into host chunks); stage 3 is the consumer,
    which receives chunk ``i`` while chunk ``i+1`` is parsed and chunk
    ``i+2`` is on the wire. Breaking out of the generator cancels the
    remaining fetches.
    """

    _SENTINEL = object()
    PREFETCH_DEPTH = 4  # bounded buffering between stages

    def batched_get(
        self,
        keys: Iterable[CacheEngineKey],
    ) -> Iterator[Optional[object]]:
        key_list = list(keys)
        if not key_list:
            return
        # the retrieval contract is the longest contiguous prefix, so
        # nothing past the first miss is fetched
        hits = self.batched_contains(key_list)
        n_fetch = 0
        for hit in hits:
            if not hit:
                break
            n_fetch += 1

        stop = threading.Event()
        bytes_q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH_DEPTH)
        blob_q: "queue.Queue" = queue.Queue(maxsize=2)

        def network_worker():
            try:
                for idx in range(n_fetch):
                    if stop.is_set():
                        break
                    bs = self.connection.get(key_list[idx].to_string())
                    bytes_q.put(bs if bs else None)
            finally:
                bytes_q.put(self._SENTINEL)

        def deserialize_worker():
            try:
                while not stop.is_set():
                    bs = bytes_q.get()
                    if bs is self._SENTINEL:
                        break
                    blob_q.put(self._deserialize(bs)
                               if bs is not None else None)
            finally:
                blob_q.put(self._SENTINEL)

        t_net = threading.Thread(target=network_worker, daemon=True)
        t_de = threading.Thread(target=deserialize_worker, daemon=True)
        t_net.start()
        t_de.start()
        try:
            served = 0
            while served < n_fetch:
                blob = blob_q.get()
                if blob is self._SENTINEL or blob is None:
                    break  # evicted between MEXIST and GET
                yield blob
                served += 1
            for _ in range(served, len(key_list)):
                yield None
        finally:
            # cancel in-flight stages (the consumer may have broken out
            # early); drain both queues so neither worker blocks on a full
            # put, and re-inject a sentinel in case the drain took the one
            # the deserialize worker waits for
            stop.set()

            def _drain(q):
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass

            _drain(blob_q)
            _drain(bytes_q)
            bytes_q.put(self._SENTINEL)
            t_net.join(timeout=30)
            t_de.join(timeout=30)
