"""The host range coder: ctypes bindings and an on-demand ``g++`` build.

``csrc/lmtc_codec.cc`` is a verbatim copy of the JAX package's C++ coder
(OpenMP, one independent stream per row). It is compiled at first use with
``g++ -O3 -fopenmp`` into ``build/lmcache_tpu_torch/`` beside the package
(ignored by git). The library name carries the host's ISA flags (it is built
with ``-march=native``) and a digest of the source, so a checkout copied to
another host or an edited source is rebuilt.

This coder is the ``cachegen_device_{en,de}code="off"`` path and the
reference the Hopper range coders are held to. It is not a fallback: when
the library cannot be built, :func:`codec_available` is False and every
call raises.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from lmcache_tpu_torch.logging_utils import init_logger

logger = init_logger(__name__)

_SRC = Path(__file__).resolve().parent / "csrc" / "lmtc_codec.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lmcache_tpu_torch"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp",
          "-march=native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _lib_path() -> Path:
    """Library path keyed by the host's CPU flags (``-march=native`` code
    runs only where they match), the flags and the source."""
    feat = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feat += " " + " ".join(sorted(line.split()[2:]))
                    break
    except OSError:
        pass
    h = hashlib.sha256(feat.encode())
    h.update(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"liblmtc_codec-{h.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    path = _lib_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
        logger.info("Building the host range coder: %s", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, path)  # atomic publish
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lmtc_encode_streams.argtypes = [P, I, I, P, I, P, I, P]
    lib.lmtc_decode_streams.argtypes = [P, P, I, I, P, I, P]
    lib.lmtc_pad_streams.argtypes = [P, P, I, I, P]
    lib.lmtc_num_threads.restype = I
    return lib


def _get_lib() -> ctypes.CDLL:
    """The loaded coder; raises (with the build's error) if it cannot be
    built."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = _build()
            except (OSError, subprocess.CalledProcessError) as e:
                _build_error = getattr(e, "stderr", None) or str(e)
                logger.warning("host range coder build failed: %s",
                               _build_error)
    if _lib is None:
        raise RuntimeError(
            f"the host range coder could not be built: {_build_error}")
    return _lib


def codec_available() -> bool:
    try:
        _get_lib()
    except RuntimeError:
        return False
    return True


def num_threads() -> int:
    """OpenMP threads the coder runs on."""
    return _get_lib().lmtc_num_threads()


def encode_streams(symbols: np.ndarray,
                   cdf: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """Entropy-encode independent symbol streams.

    Args:
        symbols: uint8 [n_streams, n_symbols].
        cdf: uint16 [n_streams, n_bins + 1]; cdf[:, 0] == 0, strictly
            increasing, implied upper bound 65536 at index n_bins.

    Returns:
        (concatenated bytestream, int64 lengths [n_streams]).
    """
    lib = _get_lib()
    symbols = np.ascontiguousarray(symbols, dtype=np.uint8)
    cdf = np.ascontiguousarray(cdf, dtype=np.uint16)
    n_streams, n_symbols = symbols.shape
    n_bins = cdf.shape[1] - 1
    out_stride = 2 * n_symbols + 16  # worst case ~2 bytes/symbol + flush
    out = np.empty((n_streams, out_stride), np.uint8)
    lens = np.empty(n_streams, np.int32)
    lib.lmtc_encode_streams(symbols.ctypes.data, n_streams, n_symbols,
                            cdf.ctypes.data, n_bins, out.ctypes.data,
                            out_stride, lens.ctypes.data)
    if (lens < 0).any():
        raise RuntimeError("range coder overflow (corrupt CDF?)")
    lens64 = lens.astype(np.int64)
    mask = np.arange(out_stride)[None, :] < lens64[:, None]
    return out[mask].tobytes(), lens64


def pad_streams(payload, lens: np.ndarray, stride: int) -> np.ndarray:
    """Re-lay concatenated streams as zero-padded uint8 [n_streams, stride]
    (the transfer layout of the JAX package's device decoders)."""
    lens = np.asarray(lens, np.int64)
    n_streams = len(lens)
    offsets = np.zeros(n_streams + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    buf = np.frombuffer(payload, np.uint8, count=int(offsets[-1]))
    out = np.zeros((n_streams, stride), np.uint8)
    if buf.size:
        _get_lib().lmtc_pad_streams(buf.ctypes.data, offsets.ctypes.data,
                                    n_streams, stride, out.ctypes.data)
    return out


def decode_streams(payload, lens: np.ndarray, n_symbols: int,
                   cdf: np.ndarray) -> np.ndarray:
    """Inverse of :func:`encode_streams` -> uint8 [n_streams, n_symbols]."""
    lib = _get_lib()
    cdf = np.ascontiguousarray(cdf, dtype=np.uint16)
    n_streams = cdf.shape[0]
    n_bins = cdf.shape[1] - 1
    offsets = np.zeros(n_streams + 1, np.int64)
    np.cumsum(np.asarray(lens, np.int64), out=offsets[1:])
    buf = np.frombuffer(payload, np.uint8)
    if buf.size < offsets[-1]:
        raise ValueError(f"payload holds {buf.size} bytes, the lengths "
                         f"claim {int(offsets[-1])}")
    out = np.empty((n_streams, n_symbols), np.uint8)
    lib.lmtc_decode_streams(buf.ctypes.data, offsets.ctypes.data, n_streams,
                            n_symbols, cdf.ctypes.data, n_bins,
                            out.ctypes.data)
    return out
