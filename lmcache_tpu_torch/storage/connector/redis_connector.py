"""Redis and Redis-Sentinel connectors (a port of
``lmcache_tpu/storage/connector/redis_connector.py``; reference
lmcache/storage_backend/connector/redis_connector.py:13-120).

The ``redis`` package is optional: it is imported when a connector is
built, and without it that raises ``ImportError``, as in the JAX package.
"""

import os
from typing import List, Optional

from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.storage.connector.base_connector import RemoteConnector

logger = init_logger(__name__)


def _import_redis():
    try:
        import redis
        return redis
    except ImportError as e:
        raise ImportError(
            "redis-py is required for redis:// remote urls "
            "(pip install redis)") from e


def _scan_all(client) -> List[str]:
    """Every key of ``client``'s database, by SCAN in batches of 1000."""
    cursor = 0
    keys: List[str] = []
    while True:
        cursor, batch = client.scan(cursor=cursor, count=1000)
        keys.extend(k.decode("utf-8") if isinstance(k, bytes) else k
                    for k in batch)
        if cursor == 0:
            return keys


def _exists_all(client, keys: List[str]) -> List[bool]:
    """Existence of ``keys`` in one pipelined round trip."""
    if not keys:
        return []
    pipe = client.pipeline(transaction=False)
    for k in keys:
        pipe.exists(k)
    return [bool(r) for r in pipe.execute()]


class RedisConnector(RemoteConnector):

    def __init__(self, host: str, port: int):
        redis = _import_redis()
        self.connection = redis.Redis(host=host, port=port)

    def exists(self, key: str) -> bool:
        return bool(self.connection.exists(key))

    def batched_exists(self, keys: List[str]) -> List[bool]:
        return _exists_all(self.connection, keys)

    def get(self, key: str) -> Optional[bytes]:
        return self.connection.get(key)

    def set(self, key: str, obj: bytes) -> None:
        self.connection.set(key, obj)

    def list(self) -> List[str]:
        return _scan_all(self.connection)

    def close(self) -> None:
        self.connection.close()


class RedisSentinelConnector(RemoteConnector):
    """Writes go to the master, reads to a replica.

    Environment (as the reference): ``REDIS_SERVICE_NAME`` (default
    ``"redismaster"``), ``REDIS_TIMEOUT`` (seconds, default 1).
    """

    ENV_SERVICE_NAME = "REDIS_SERVICE_NAME"
    ENV_TIMEOUT = "REDIS_TIMEOUT"

    def __init__(self, hosts_and_ports: List[tuple]):
        redis = _import_redis()
        service_name = os.environ.get(self.ENV_SERVICE_NAME, "redismaster")
        timeout = float(os.environ.get(self.ENV_TIMEOUT, 1.0))
        sentinel = redis.Sentinel(hosts_and_ports, socket_timeout=timeout)
        self.master = sentinel.master_for(service_name,
                                          socket_timeout=timeout)
        self.slave = sentinel.slave_for(service_name, socket_timeout=timeout)

    def exists(self, key: str) -> bool:
        return bool(self.slave.exists(key))

    def batched_exists(self, keys: List[str]) -> List[bool]:
        return _exists_all(self.slave, keys)

    def get(self, key: str) -> Optional[bytes]:
        return self.slave.get(key)

    def set(self, key: str, obj: bytes) -> None:
        self.master.set(key, obj)

    def list(self) -> List[str]:
        return _scan_all(self.slave)

    def close(self) -> None:
        self.master.close()
        self.slave.close()
