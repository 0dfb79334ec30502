"""Local cache tiers: GPU memory ("cuda"), host DRAM ("cpu") and disk.

Port of ``lmcache_tpu/storage/local_backend.py``: ``LMCLocalBackend``, an
LRU dict of KV chunk tensors under an optional byte budget, and
``LMCLocalDiskBackend``, one raw container (``storage/serde/raw_serde.py``)
a chunk in a directory whose append-only key index is replayed on restart.
Both finish non-blocking puts on a single-worker executor.

Unlike JAX arrays, the tensors handed to :meth:`LMCLocalBackend.put` may be
views of a pool that the caller updates in place and reuses. Every put
therefore stores a private contiguous copy, taken on the caller's thread and
CUDA stream before ``put`` returns; a non-blocking put leaves only the
cross-device transfer (if any) and the bookkeeping to the worker. The disk
tier's non-blocking put copies a CUDA blob into pinned host memory on the
caller's stream; its worker waits for that copy before it writes the file.
"""

import hashlib
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from lmcache_tpu_torch import metrics
from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.storage.abstract_backend import LMCBackendInterface
from lmcache_tpu_torch.storage.serde.raw_serde import (decode_array,
                                                       encode_array)
from lmcache_tpu_torch.utils import (CacheEngineKey, _lmcache_trace_annotate,
                                     nbytes_of, resolve_device)

logger = init_logger(__name__)


def _copy_to(blob: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A private contiguous copy of ``blob`` on ``device`` (one copy)."""
    out = torch.empty(blob.shape, dtype=blob.dtype, device=device)
    out.copy_(blob)
    return out


class LMCLocalBackend(LMCBackendInterface):
    """In-process KV chunk store on the GPU ("cuda") or host DRAM ("cpu").
    ``"cuda"`` raises when no GPU is present."""

    def __init__(self, device: str = "cuda",
                 capacity_bytes: Optional[int] = None):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"Invalid local device: {device}")
        self.device = resolve_device(device)
        self.tier = "hbm" if device == "cuda" else "dram"
        self.capacity_bytes = capacity_bytes
        self.dict: "OrderedDict[CacheEngineKey, torch.Tensor]" = OrderedDict()
        self.lock = threading.Lock()
        self.total_bytes = 0
        self.evictions = 0
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="lmc-local-put")
        self._pending: List[Future] = []
        self._pending_lock = threading.Lock()
        self._closed = False

    # -- interface ---------------------------------------------------------

    def contains(self, key: CacheEngineKey) -> bool:
        with self.lock:
            return key in self.dict

    @_lmcache_trace_annotate
    def put(self, key: CacheEngineKey, blob, blocking: bool = True) -> None:
        """Store a copy of ``blob`` (a tensor or numpy array) under ``key``.
        The copy is taken on the caller's stream before this returns, so the
        caller may overwrite ``blob`` right away, also when
        ``blocking=False``."""
        t0 = time.perf_counter()
        blob = torch.as_tensor(blob)
        if blocking:
            self._insert(key, _copy_to(blob, self.device), t0)
            return
        if blob.device == self.device:
            snap, ready = _copy_to(blob, self.device), None
        else:
            # the worker moves it across; it waits for the snapshot first
            snap = _copy_to(blob, blob.device)
            ready = None
            if snap.is_cuda:
                ready = torch.cuda.Event()
                ready.record()
        with self._pending_lock:
            self._pending = [f for f in self._pending if not f.done()]
            self._pending.append(
                self._executor.submit(self._put_snapshot, key, snap, ready,
                                      t0))

    def _put_snapshot(self, key, snap, ready, t0) -> None:
        if ready is not None:
            ready.synchronize()
        if snap.device != self.device:
            snap = _copy_to(snap, self.device)
        self._insert(key, snap, t0)

    def _insert(self, key: CacheEngineKey, placed: torch.Tensor,
                t0: float) -> None:
        size = nbytes_of(placed)
        with self.lock:
            old = self.dict.pop(key, None)
            if old is not None:
                self.total_bytes -= nbytes_of(old)
            self.dict[key] = placed
            self.total_bytes += size
            self._evict_locked()
        metrics.observe("lmcache_tier_put_seconds",
                        time.perf_counter() - t0,
                        labels={"tier": self.tier})

    def _evict_locked(self) -> None:
        if self.capacity_bytes is None:
            return
        while self.total_bytes > self.capacity_bytes and len(self.dict) > 1:
            _, victim = self.dict.popitem(last=False)
            self.total_bytes -= nbytes_of(victim)
            self.evictions += 1
        if self.total_bytes > self.capacity_bytes and self.dict:
            # a single chunk larger than the tier budget: enforce the
            # budget strictly (on the GPU, exceeding it risks an OOM that
            # kills serving — worse than one lost cache entry)
            key, victim = self.dict.popitem(last=False)
            self.total_bytes -= nbytes_of(victim)
            self.evictions += 1
            logger.warning(
                "Evicted just-stored %s: chunk (%d B) exceeds the %s "
                "tier budget (%d B)", key.to_string(), nbytes_of(victim),
                self.tier, self.capacity_bytes)

    @_lmcache_trace_annotate
    def get(self, key: CacheEngineKey):
        """The stored tensor itself (not a copy): callers must not modify
        it in place."""
        t0 = time.perf_counter()
        with self.lock:
            blob = self.dict.get(key)
            if blob is not None:
                self.dict.move_to_end(key)  # LRU touch
        if blob is not None:
            metrics.observe("lmcache_tier_get_seconds",
                            time.perf_counter() - t0,
                            labels={"tier": self.tier})
        return blob

    def flush(self) -> None:
        """Wait for all in-flight non-blocking puts."""
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


def _host_snapshot(blob: torch.Tensor):
    """A private host copy of ``blob`` and, for a CUDA blob, an event
    recorded after it: the copy into pinned memory is queued on the
    caller's stream without blocking, so the caller may overwrite ``blob``
    at once and the reader waits on the event."""
    out = torch.empty(blob.shape, dtype=blob.dtype, pin_memory=blob.is_cuda)
    out.copy_(blob, non_blocking=blob.is_cuda)
    ready = None
    if blob.is_cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(blob.device))
    return out, ready


def _read_exactly(f, buf: memoryview, key) -> None:
    """Fill ``buf`` from the unbuffered file ``f``: a read may return fewer
    bytes than asked (network and FUSE file systems, reads over 2 GiB), so
    it loops, and raises if the file ends first (truncated under the
    reader)."""
    done = 0
    while done < len(buf):
        n = f.readinto(buf[done:])
        if not n:
            raise OSError(f"disk tier: the file of {key} ended after {done} "
                          f"of {len(buf)} bytes")
        done += n


class LMCLocalDiskBackend(LMCBackendInterface):
    """Disk tier: one raw container file a chunk in ``path``.

    Files are named by a sha256 of the key string, so model names with any
    characters cannot collide. Every new key is appended to ``keys.idx``;
    a backend opened on the directory again replays it and keeps the keys
    whose file exists (restart recovery). ``get`` returns a CPU tensor: the
    consumer moves it to its device.
    """

    _INDEX = "keys.idx"

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.lock = threading.Lock()
        self.existing_keys = set()
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="lmc-disk-put")
        self._pending: List[Future] = []
        self._pending_lock = threading.Lock()
        self._closed = False
        index_path = os.path.join(path, self._INDEX)
        if os.path.exists(index_path):
            with open(index_path, "r") as f:
                for line in f:
                    key_str = line.strip()
                    if not key_str:
                        continue
                    try:
                        key = CacheEngineKey.from_string(key_str)
                    except ValueError:
                        logger.warning("Skipping bad index line %r", key_str)
                        continue
                    if os.path.exists(self._key_to_path(key)):
                        self.existing_keys.add(key)

    def _key_to_path(self, key: CacheEngineKey) -> str:
        digest = hashlib.sha256(
            key.to_string().encode("utf-8")).hexdigest()[:40]
        return os.path.join(self.path, digest + ".lmtc")

    def contains(self, key: CacheEngineKey) -> bool:
        with self.lock:
            return key in self.existing_keys

    @_lmcache_trace_annotate
    def put(self, key: CacheEngineKey, blob, blocking: bool = True) -> None:
        """Write ``blob`` (a tensor or numpy array) to its file. With
        ``blocking=False`` the caller may overwrite ``blob`` as soon as this
        returns (:func:`_host_snapshot`)."""
        t0 = time.perf_counter()
        blob = torch.as_tensor(blob)
        if blocking:
            self._write(key, blob, None, t0)
            return
        snap, ready = _host_snapshot(blob)
        with self._pending_lock:
            self._pending = [f for f in self._pending if not f.done()]
            self._pending.append(
                self._executor.submit(self._write, key, snap, ready, t0))

    def _write(self, key: CacheEngineKey, blob: torch.Tensor, ready,
               t0: float) -> None:
        if ready is not None:
            ready.synchronize()
        data = encode_array(blob)
        path = self._key_to_path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish
        with self.lock:
            if key not in self.existing_keys:
                with open(os.path.join(self.path, self._INDEX), "a") as f:
                    f.write(key.to_string() + "\n")
            self.existing_keys.add(key)
        metrics.observe("lmcache_tier_put_seconds",
                        time.perf_counter() - t0, labels={"tier": "disk"})

    @_lmcache_trace_annotate
    def get(self, key: CacheEngineKey):
        if not self.contains(key):
            return None
        t0 = time.perf_counter()
        with open(self._key_to_path(key), "rb", buffering=0) as f:
            data = np.empty(os.fstat(f.fileno()).st_size, np.uint8)
            _read_exactly(f, memoryview(data), key)
        blob = decode_array(data)
        metrics.observe("lmcache_tier_get_seconds",
                        time.perf_counter() - t0, labels={"tier": "disk"})
        return blob

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
