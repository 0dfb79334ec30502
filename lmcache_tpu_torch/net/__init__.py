"""Native (C++) framed-TCP client for the cache-server protocol.

Port of ``lmcache_tpu/net/__init__.py``. ``csrc/lmtc_net.cc`` is a copy of
the JAX package's C ABI (blocking sockets, ``TCP_NODELAY``, a GET's payload
received straight into a caller's buffer). It is compiled at first use with
``g++`` into ``build/lmcache_tpu_torch/`` beside the package (ignored by
git): the library is named by a digest of the flags and the source, built
under a per-process temporary name and published with an atomic
``os.replace``, so parallel processes never load a half-written library.

The connector (:mod:`lmcache_tpu_torch.storage.connector.lm_connector`)
runs EXIST, GET and PUT through this client. There is no fallback: when the
library cannot be built, :func:`native_transport_available` is False and
:class:`NativeSocketClient` raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from lmcache_tpu_torch.logging_utils import init_logger

logger = init_logger(__name__)

_SRC = Path(__file__).resolve().parent / "csrc" / "lmtc_net.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lmcache_tpu_torch"
CXX = "g++"
_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"liblmtc_net-{h.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    path = _lib_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [CXX, *_FLAGS, str(_SRC), "-o", str(tmp)]
        logger.info("Building the native transport: %s", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, path)  # atomic publish
    lib = ctypes.CDLL(str(path))
    P, I, I64, S = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_char_p)
    lib.lmtc_connect.argtypes = [S, I]
    lib.lmtc_connect.restype = I
    lib.lmtc_disconnect.argtypes = [I]
    lib.lmtc_put.argtypes = [I, S, I, P, I64]
    lib.lmtc_put.restype = I
    lib.lmtc_get_begin.argtypes = [I, S, I]
    lib.lmtc_get_begin.restype = I64
    lib.lmtc_read_payload.argtypes = [I, P, I64]
    lib.lmtc_read_payload.restype = I
    lib.lmtc_exists.argtypes = [I, S, I]
    lib.lmtc_exists.restype = I
    return lib


def _get_lib() -> ctypes.CDLL:
    """The loaded transport; raises (with the build's error) if it cannot
    be built. A failed build is not retried in this process."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = _build()
            except (OSError, subprocess.CalledProcessError) as e:
                _build_error = getattr(e, "stderr", None) or str(e)
                logger.warning("native transport build failed: %s",
                               _build_error)
    if _lib is None:
        raise RuntimeError(
            f"the native transport could not be built: {_build_error}")
    return _lib


def native_transport_available() -> bool:
    try:
        _get_lib()
    except RuntimeError:
        return False
    return True


class NativeSocketClient:
    """Blocking framed-protocol client over the C++ transport.

    One request in flight per connection (a lock). A request that meets a
    dead connection reconnects once and is sent again; a second failure, a
    failed connect or a short payload raises ``ConnectionError``. A GET
    lands in a new ``numpy`` uint8 array, returned as a ``memoryview`` of
    it (it compares equal to the same ``bytes``): the parsers read it
    without a copy.
    """

    def __init__(self, host: str, port: int):
        self._l = _get_lib()
        self.host, self.port = host, port
        self.lock = threading.Lock()
        self.fd = -1
        self._connect()

    def _connect(self):
        self.fd = self._l.lmtc_connect(self.host.encode(), self.port)
        if self.fd < 0:
            raise ConnectionError(
                f"native transport: connect {self.host}:{self.port} failed")

    def _drop(self):
        if self.fd >= 0:
            self._l.lmtc_disconnect(self.fd)
            self.fd = -1

    def _retrying(self, call):
        """``call(fd)``, once more on a fresh connection if it reports a
        transport error (-1)."""
        if self.fd >= 0:
            r = call(self.fd)
            if r != -1:
                return r
        logger.warning("Connection to %s:%d lost; reconnecting", self.host,
                       self.port)
        self._drop()
        self._connect()
        return call(self.fd)

    def set(self, key: str, obj) -> None:
        kb = key.encode("utf-8")
        buf = np.frombuffer(obj, np.uint8)
        ptr = buf.ctypes.data if buf.size else None
        with self.lock:
            code = self._retrying(
                lambda fd: self._l.lmtc_put(fd, kb, len(kb), ptr, buf.size))
        if code == -1:
            raise ConnectionError(f"PUT transport error for {key}")
        if code != 200:
            raise RuntimeError(f"Remote PUT failed ({code}) for {key}")

    def get(self, key: str) -> Optional[memoryview]:
        kb = key.encode("utf-8")
        with self.lock:
            n = self._retrying(
                lambda fd: self._l.lmtc_get_begin(fd, kb, len(kb)))
            if n == -404:
                return None
            if n < 0:
                self._drop()
                raise ConnectionError(f"GET transport error for {key}")
            out = np.empty(int(n), np.uint8)
            if n and self._l.lmtc_read_payload(self.fd, out.ctypes.data,
                                               int(n)) != 0:
                self._drop()  # the stream is out of step: reconnect next
                raise ConnectionError(f"GET payload error for {key}")
        return memoryview(out)

    def exists(self, key: str) -> bool:
        kb = key.encode("utf-8")
        with self.lock:
            r = self._retrying(
                lambda fd: self._l.lmtc_exists(fd, kb, len(kb)))
        if r < 0:
            raise ConnectionError(f"EXIST transport error for {key}")
        return bool(r)

    def close(self) -> None:
        with self.lock:
            self._drop()
