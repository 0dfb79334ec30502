"""Connector factory and remote-URL parsing (a port of
``lmcache_tpu/storage/connector/__init__.py``; reference
lmcache/storage_backend/connector/__init__.py:16-102). URL grammar:

    <connector_type>://<host>:<port>[,<host>:<port>...]

types: ``lm`` (the cache server), ``redis`` and ``redis-sentinel`` (these
need the ``redis`` package; :mod:`.redis_connector`).
"""

import re
from dataclasses import dataclass
from typing import List, Tuple

from lmcache_tpu_torch.config import GlobalConfig
from lmcache_tpu_torch.storage.connector.base_connector import (
    RemoteConnector, RemoteConnectorDebugWrapper)
from lmcache_tpu_torch.storage.connector.lm_connector import \
    LMCServerConnector

__all__ = [
    "RemoteConnector",
    "CreateConnector",
    "parse_remote_url",
    "ParsedRemoteURL",
]

_URL_RE = re.compile(r"^([\w-]+)://(.+)$")
_HOSTPORT_RE = re.compile(r"^([^:]+):(\d+)$")


@dataclass
class ParsedRemoteURL:
    connector_type: str
    hosts_and_ports: List[Tuple[str, int]]


def parse_remote_url(url: str) -> ParsedRemoteURL:
    m = _URL_RE.match(url)
    if m is None:
        raise ValueError(f"Invalid remote url: {url}")
    connector_type, rest = m.group(1), m.group(2)
    hosts_and_ports = []
    for part in rest.split(","):
        hm = _HOSTPORT_RE.match(part)
        if hm is None:
            raise ValueError(f"Invalid host:port in remote url: {part}")
        hosts_and_ports.append((hm.group(1), int(hm.group(2))))
    return ParsedRemoteURL(connector_type, hosts_and_ports)


def CreateConnector(url: str) -> RemoteConnector:
    parsed = parse_remote_url(url)
    hosts = parsed.hosts_and_ports
    if len(hosts) > 1 and parsed.connector_type != "redis-sentinel":
        raise ValueError(
            f"Multiple hosts not supported for {parsed.connector_type}://")

    connector: RemoteConnector
    if parsed.connector_type == "lm":
        connector = LMCServerConnector(*hosts[0])
    elif parsed.connector_type == "redis":
        from lmcache_tpu_torch.storage.connector.redis_connector import \
            RedisConnector
        connector = RedisConnector(*hosts[0])
    elif parsed.connector_type == "redis-sentinel":
        from lmcache_tpu_torch.storage.connector.redis_connector import \
            RedisSentinelConnector
        connector = RedisSentinelConnector(hosts)
    else:
        raise ValueError(f"Invalid connector type: {parsed.connector_type}")
    if GlobalConfig.is_debug():
        return RemoteConnectorDebugWrapper(connector)
    return connector
