"""TCP client for the cache server (:mod:`lmcache_tpu_torch.server`).

Port of ``lmcache_tpu/storage/connector/lm_connector.py``: the framed
protocol of :mod:`lmcache_tpu_torch.protocol` over two clients. With
``use_native=True`` (the default) EXIST, GET and PUT run through the C++
transport of :mod:`lmcache_tpu_torch.net`, whose GET lands in a ``numpy``
buffer handed on as a ``memoryview``, which the parsers read without a
copy; LIST, PING and MEXIST stay on
the pure-Python socket client, a blocking socket with lock-serialized
request/response. Unlike the JAX connector, which falls back to Python with
a warning, a native transport that cannot be built or connect raises;
``use_native=False`` selects the Python client for every command. PUT waits
for the server's ack, so a completed ``set`` means the data is held by the
server.
"""

import socket
import threading
from typing import List, Optional

from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.net import NativeSocketClient
from lmcache_tpu_torch.protocol import (RESPONSE_HEADER_SIZE, Code, Command,
                                        RequestHeader, ResponseHeader)
from lmcache_tpu_torch.storage.connector.base_connector import RemoteConnector

logger = init_logger(__name__)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes or raise ConnectionError on EOF."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("Connection closed by peer")
        got += r
    return bytes(buf)


class LMCServerConnector(RemoteConnector):

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 use_native: bool = True):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.lock = threading.Lock()
        self.socket: Optional[socket.socket] = None
        self._connect()
        self.native: Optional[NativeSocketClient] = None
        if use_native:
            try:
                self.native = NativeSocketClient(host, port)
            except BaseException:
                self.close()
                raise

    def _connect(self) -> None:
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.socket = s

    def _exchange(self, req: bytes, payload: bytes) -> tuple:
        self.socket.sendall(req)
        if payload:
            self.socket.sendall(payload)
        header = ResponseHeader.unpack(
            recv_exact(self.socket, RESPONSE_HEADER_SIZE))
        body = (recv_exact(self.socket, header.payload_length)
                if header.payload_length else b"")
        return header.code, body

    def _request(self, command: Command, key: str,
                 payload: bytes = b"") -> tuple:
        """Send one frame, read one response. Returns (code, payload)."""
        req = RequestHeader(command, key, len(payload)).pack()
        with self.lock:
            try:
                return self._exchange(req, payload)
            except (ConnectionError, socket.timeout, OSError):
                # one reconnect attempt, then re-raise
                logger.warning("Connection to %s:%d lost; reconnecting",
                               self.host, self.port)
                self._connect()
                return self._exchange(req, payload)

    def exists(self, key: str) -> bool:
        if self.native is not None:
            return self.native.exists(key)
        code, _ = self._request(Command.EXIST, key)
        return code == Code.OK

    def get(self, key: str):
        """The stored bytes (a ``memoryview`` of the receive buffer on the
        native transport, ``bytes`` on the Python one), or None."""
        if self.native is not None:
            return self.native.get(key)
        code, body = self._request(Command.GET, key)
        return body if code == Code.OK else None

    def set(self, key: str, obj: bytes) -> None:
        if self.native is not None:
            self.native.set(key, obj)
            return
        code, _ = self._request(Command.PUT, key, obj)
        if code != Code.OK:
            raise RuntimeError(f"Remote PUT failed for key {key}")

    def list(self) -> List[str]:
        code, body = self._request(Command.LIST, "")
        if code != Code.OK or not body:
            return []
        return body.decode("utf-8").split("\n")

    def batched_exists(self, keys: List[str]) -> List[bool]:
        """One MEXIST round trip for the whole batch; per-key EXIST against
        a server that answers FAIL for the command."""
        if not keys:
            return []
        code, body = self._request(Command.MEXIST, "",
                                   "\n".join(keys).encode("utf-8"))
        if code == Code.OK and len(body) == len(keys):
            return [b == 1 for b in body]
        logger.warning("MEXIST unsupported by server; falling back to "
                       "per-key EXIST")
        return [self.exists(k) for k in keys]

    def ping(self) -> bool:
        try:
            code, _ = self._request(Command.PING, "")
            return code == Code.OK
        except (ConnectionError, OSError):
            return False

    def close(self) -> None:
        if getattr(self, "native", None) is not None:
            self.native.close()
            self.native = None
        if self.socket is not None:
            try:
                self.socket.close()
            except OSError:
                pass
            self.socket = None
