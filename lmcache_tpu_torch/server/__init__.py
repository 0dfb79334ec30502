"""Standalone cache server, a copy of ``lmcache_tpu/server`` (reference:
lmcache/server/__main__.py:9-126). It holds opaque bytes and speaks the
protocol of :mod:`lmcache_tpu_torch.protocol`, so either package's clients
use it.

asyncio event-loop server instead of the reference's thread-per-client:
one process scales to hundreds of serving-engine clients without GIL-bound
thread churn, and every command (including PUT — unlike the reference,
which never acked PUTs) gets an explicit response frame.
"""

import asyncio
from typing import Optional

from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.protocol import (REQUEST_HEADER_SIZE, Code, Command,
                                  RequestHeader, ResponseHeader)
from lmcache_tpu_torch.server.storage import CreateServerStorage

logger = init_logger(__name__)


class LMCacheServer:

    def __init__(self, host: str, port: int, device: str = "cpu"):
        self.host = host
        self.port = port
        self.storage = CreateServerStorage(device)
        self._server: Optional[asyncio.AbstractServer] = None
        self.stats = {"put": 0, "get": 0, "hit": 0, "miss": 0}

    async def _handle_client(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        logger.debug("Client connected: %s", peer)
        try:
            while True:
                try:
                    fixed = await reader.readexactly(REQUEST_HEADER_SIZE)
                except asyncio.IncompleteReadError:
                    break
                command, key_len, payload_len = RequestHeader.unpack_fixed(
                    fixed)
                key = (await reader.readexactly(key_len)).decode("utf-8") \
                    if key_len else ""
                payload = (await reader.readexactly(payload_len)
                           if payload_len else b"")
                resp_code, resp_body = self._dispatch(command, key, payload)
                writer.write(
                    ResponseHeader(resp_code, len(resp_body)).pack())
                if resp_body:
                    writer.write(resp_body)
                await writer.drain()
        except (ConnectionResetError, ValueError) as e:
            logger.warning("Client %s error: %s", peer, e)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            logger.debug("Client disconnected: %s", peer)

    def _dispatch(self, command: Command, key: str,
                  payload: bytes) -> tuple:
        if command == Command.PUT:
            self.storage.put(key, payload)
            self.stats["put"] += 1
            return Code.OK, b""
        if command == Command.GET:
            data = self.storage.get(key)
            self.stats["get"] += 1
            if data is None:
                self.stats["miss"] += 1
                return Code.NOT_FOUND, b""
            self.stats["hit"] += 1
            return Code.OK, data
        if command == Command.EXIST:
            return (Code.OK, b"") if self.storage.contains(key) \
                else (Code.NOT_FOUND, b"")
        if command == Command.MEXIST:
            # one byte per '\n'-separated key: 1 = present
            if not payload:
                return Code.OK, b""
            ks = payload.decode("utf-8").split("\n")
            return Code.OK, bytes(
                1 if self.storage.contains(k) else 0 for k in ks)
        if command == Command.LIST:
            keys = self.storage.list_keys()
            if key:  # optional prefix filter
                keys = [k for k in keys if k.startswith(key)]
            return Code.OK, "\n".join(keys).encode("utf-8")
        if command == Command.DEL:
            return (Code.OK, b"") if self.storage.delete(key) \
                else (Code.NOT_FOUND, b"")
        if command in (Command.PING, Command.HEALTH):
            return Code.OK, b""
        return Code.FAIL, b""

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle_client,
                                                  self.host, self.port)
        logger.info("Cache server listening on %s:%d", self.host, self.port)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self.storage.close()

    def run(self) -> None:
        try:
            asyncio.run(self.serve_forever())
        except KeyboardInterrupt:
            logger.info("Server interrupted; shutting down")
