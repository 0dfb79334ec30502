"""Remote connector interface + observability wrapper (a copy of
``lmcache_tpu/storage/connector/base_connector.py``).

Capability parity with reference
lmcache/storage_backend/connector/base_connector.py:11-107.
"""

import abc
from typing import List, Optional

from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.utils import Timer

logger = init_logger(__name__)


class RemoteConnector(metaclass=abc.ABCMeta):

    @abc.abstractmethod
    def exists(self, key: str) -> bool:
        raise NotImplementedError

    @abc.abstractmethod
    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    @abc.abstractmethod
    def set(self, key: str, obj: bytes) -> None:
        raise NotImplementedError

    @abc.abstractmethod
    def list(self) -> List[str]:
        """All keys currently held by the remote store."""
        raise NotImplementedError

    def batched_exists(self, keys: List[str]) -> List[bool]:
        """Existence of many keys. Connectors override this with a single
        round trip (MEXIST / pipelining); the default loops."""
        return [self.exists(k) for k in keys]

    @abc.abstractmethod
    def close(self) -> None:
        raise NotImplementedError


class RemoteConnectorDebugWrapper(RemoteConnector):
    """Logs throughput (MB, ms, Gbps) of every get/set."""

    def __init__(self, connector: RemoteConnector):
        self._connector = connector

    def exists(self, key: str) -> bool:
        return self._connector.exists(key)

    def get(self, key: str) -> Optional[bytes]:
        with Timer() as t:
            ret = self._connector.get(key)
        if ret is None or len(ret) == 0:
            logger.debug("Remote get miss for %s (%.2f ms)", key, t.ms)
            return ret
        logger.debug("Remote get %.2f MB in %.2f ms (%.2f Gbps)",
                     len(ret) / 1e6, t.ms, 8 * len(ret) / t.ms / 1e6)
        return ret

    def set(self, key: str, obj: bytes) -> None:
        with Timer() as t:
            self._connector.set(key, obj)
        logger.debug("Remote set %.2f MB in %.2f ms (%.2f Gbps)",
                     len(obj) / 1e6, t.ms,
                     8 * len(obj) / max(t.ms, 1e-9) / 1e6)

    def list(self) -> List[str]:
        return self._connector.list()

    def batched_exists(self, keys: List[str]) -> List[bool]:
        with Timer() as t:
            ret = self._connector.batched_exists(keys)
        logger.debug("Remote mexist of %d keys in %.2f ms (%d hits)",
                     len(keys), t.ms, sum(ret))
        return ret

    def close(self) -> None:
        return self._connector.close()
