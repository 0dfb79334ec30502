"""Connector factory and remote-URL parsing (a port of
``lmcache_tpu/storage/connector/__init__.py``; reference
lmcache/storage_backend/connector/__init__.py:16-102). URL grammar:

    <connector_type>://<host>:<port>[,<host>:<port>...]

types: ``lm`` (the cache server). ``redis`` and ``redis-sentinel`` are not
ported yet (ROADMAP, module item 8) and raise ``NotImplementedError``.
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
    if parsed.connector_type in ("redis", "redis-sentinel"):
        raise NotImplementedError(
            f"{parsed.connector_type}:// is not ported yet (ROADMAP, module "
            f"item 8)")
    if parsed.connector_type != "lm":
        raise ValueError(f"Invalid connector type: {parsed.connector_type}")
    if len(parsed.hosts_and_ports) > 1:
        raise ValueError("Multiple hosts not supported for lm://")
    connector: RemoteConnector = LMCServerConnector(
        *parsed.hosts_and_ports[0])
    if GlobalConfig.is_debug():
        return RemoteConnectorDebugWrapper(connector)
    return connector
