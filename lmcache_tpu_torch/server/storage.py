"""Byte-oriented storage backends for the standalone cache server (a copy
of ``lmcache_tpu/server/storage.py``).

Capability parity with reference
lmcache/server/server_storage_backend/ (LMSLocalBackend, LMSLocalDiskBackend,
factory on device string). The server never touches tensors — values are
opaque byte strings.
"""

import abc
import hashlib
import os
import threading
from collections import OrderedDict
from typing import List, Optional

from lmcache_tpu_torch.logging_utils import init_logger

logger = init_logger(__name__)


class LMSBackendInterface(metaclass=abc.ABCMeta):

    @abc.abstractmethod
    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    @abc.abstractmethod
    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    @abc.abstractmethod
    def contains(self, key: str) -> bool:
        raise NotImplementedError

    @abc.abstractmethod
    def delete(self, key: str) -> bool:
        raise NotImplementedError

    @abc.abstractmethod
    def list_keys(self) -> List[str]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LMSMemoryBackend(LMSBackendInterface):
    """In-memory dict store with optional byte-budget LRU eviction.

    LIST order is a protocol invariant: keys come back in STORE order
    (oldest stored first), independent of the access-recency order the
    LRU maintains internally — clients (the hybrid backend's bounded
    prefetch) rely on the tail being the most recently stored chunks.
    """

    def __init__(self, capacity_bytes: Optional[int] = None):
        self.dict: "OrderedDict[str, bytes]" = OrderedDict()  # LRU order
        self.store_order: "OrderedDict[str, None]" = OrderedDict()
        self.lock = threading.Lock()
        self.capacity_bytes = capacity_bytes
        self.total_bytes = 0

    def put(self, key: str, data: bytes) -> None:
        with self.lock:
            old = self.dict.pop(key, None)
            if old is not None:
                self.total_bytes -= len(old)
            self.dict[key] = data
            self.store_order.pop(key, None)  # re-put refreshes store time
            self.store_order[key] = None
            self.total_bytes += len(data)
            if self.capacity_bytes is not None:
                while (self.total_bytes > self.capacity_bytes
                       and len(self.dict) > 1):
                    victim_key, victim = self.dict.popitem(last=False)
                    self.store_order.pop(victim_key, None)
                    self.total_bytes -= len(victim)

    def get(self, key: str) -> Optional[bytes]:
        with self.lock:
            data = self.dict.get(key)
            if data is not None:
                self.dict.move_to_end(key)
            return data

    def contains(self, key: str) -> bool:
        with self.lock:
            return key in self.dict

    def delete(self, key: str) -> bool:
        with self.lock:
            old = self.dict.pop(key, None)
            if old is not None:
                self.total_bytes -= len(old)
                self.store_order.pop(key, None)
            return old is not None

    def list_keys(self) -> List[str]:
        with self.lock:
            return list(self.store_order.keys())


class LMSDiskBackend(LMSBackendInterface):
    """File-per-key store; the directory is the persistent artifact.

    LIST order follows the memory backend's protocol invariant: store
    order, oldest first — the append-only index file records it and a
    re-put appends again (replay keeps the latest position)."""

    _INDEX = "keys.idx"

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.lock = threading.Lock()
        self.key_index: "OrderedDict[str, str]" = OrderedDict()  # key -> file
        index_path = os.path.join(path, self._INDEX)
        if os.path.exists(index_path):
            with open(index_path, "r") as f:
                for line in f:
                    key = line.rstrip("\n")
                    if not key:
                        continue
                    fname = self._fname(key)
                    if os.path.exists(os.path.join(path, fname)):
                        # a later duplicate line = a re-put; refresh the
                        # key's store-order position
                        self.key_index.pop(key, None)
                        self.key_index[key] = fname

    def _fname(self, key: str) -> str:
        return hashlib.sha256(key.encode("utf-8")).hexdigest()[:40] + ".bin"

    def put(self, key: str, data: bytes) -> None:
        fname = self._fname(key)
        fpath = os.path.join(self.path, fname)
        tmp = fpath + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, fpath)
        with self.lock:
            with open(os.path.join(self.path, self._INDEX), "a") as f:
                f.write(key + "\n")
            self.key_index.pop(key, None)
            self.key_index[key] = fname

    def get(self, key: str) -> Optional[bytes]:
        with self.lock:
            fname = self.key_index.get(key)
        if fname is None:
            return None
        with open(os.path.join(self.path, fname), "rb") as f:
            return f.read()

    def contains(self, key: str) -> bool:
        with self.lock:
            return key in self.key_index

    def delete(self, key: str) -> bool:
        with self.lock:
            fname = self.key_index.pop(key, None)
        if fname is None:
            return False
        try:
            os.remove(os.path.join(self.path, fname))
        except FileNotFoundError:
            pass
        return True

    def list_keys(self) -> List[str]:
        with self.lock:
            return list(self.key_index.keys())


def CreateServerStorage(device: str) -> LMSBackendInterface:
    if device == "cpu":
        return LMSMemoryBackend()
    return LMSDiskBackend(device)
