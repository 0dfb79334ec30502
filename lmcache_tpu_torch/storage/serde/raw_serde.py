"""Lossless serde with a self-describing binary container.

Port of ``lmcache_tpu/storage/serde/raw_serde.py``: the same container, byte
for byte, so either package reads what the other wrote. bfloat16 travels as
its raw bytes (``tensor.view(torch.uint8)``), with no ``ml_dtypes``.

Container layout (little endian):

    magic   4s   b"LMTC"
    version u8   = 1
    flags   u8   bit0: zstd-compressed payload
    ndim    u8
    dlen    u8   length of dtype-name string
    nbytes  u64  payload byte length (uncompressed)
    shape   u64 * ndim
    dtype   dlen ascii bytes (numpy dtype name, e.g. "bfloat16")
    payload raw array bytes (zstd-framed where bit 0 is set)

A decoded blob is a CPU tensor (the JAX package returns a numpy array): the
consumer moves it to its device. ``compress_level`` (the ``raw_zstd``
serde) compresses the payload with ``zstandard``, which is imported where it
is used: without it, encoding or decoding such a container raises
``ImportError``.
"""

import struct
from typing import Optional

import numpy as np
import torch

from lmcache_tpu_torch.storage.serde.serde import Deserializer, Serializer

MAGIC = b"LMTC"
VERSION = 1
_HDR = struct.Struct("<4sBBBBQ")
_FLAG_ZSTD = 1


def _zstandard():
    try:
        import zstandard
    except ImportError as e:
        raise ImportError("the raw_zstd serde needs the zstandard package "
                          "(pip install zstandard)") from e
    return zstandard


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("bfloat16", "float32", ...)."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"Unknown dtype in container: {name!r}")
    return dtype


def encode_array(blob, compress_level: Optional[int] = None) -> bytes:
    t = torch.as_tensor(blob).detach().contiguous().cpu()
    name = dtype_name(t.dtype).encode("ascii")
    payload = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    nbytes, flags = len(payload), 0
    if compress_level is not None:
        payload = _zstandard().ZstdCompressor(
            level=compress_level).compress(payload)
        flags |= _FLAG_ZSTD
    header = _HDR.pack(MAGIC, VERSION, flags, t.dim(), len(name), nbytes)
    shape = struct.pack(f"<{t.dim()}Q", *t.shape)
    return header + shape + name + payload


def decode_array(bs) -> torch.Tensor:
    magic, version, flags, ndim, dlen, nbytes = _HDR.unpack_from(bs, 0)
    if magic != MAGIC:
        raise ValueError("Not an LMTC container")
    if version != VERSION:
        raise ValueError(f"Unsupported container version {version}")
    off = _HDR.size
    shape = struct.unpack_from(f"<{ndim}Q", bs, off)
    off += 8 * ndim
    dtype = torch_dtype(bytes(bs[off:off + dlen]).decode("ascii"))
    off += dlen
    if flags & _FLAG_ZSTD:
        raw = np.frombuffer(_zstandard().ZstdDecompressor().decompress(
            memoryview(bs)[off:], max_output_size=nbytes), np.uint8).copy()
    else:
        raw = np.frombuffer(bs, np.uint8, offset=off)
        # bytes are copied (a native GET's or a file's buffer is taken), and
        # so is a payload that does not start at a multiple of its item size
        if not raw.flags.writeable or off % dtype.itemsize:
            raw = raw.copy()
    if len(raw) != nbytes:
        raise ValueError(f"Corrupt LMTC container: {len(raw)} payload "
                         f"bytes, header says {nbytes}")
    raw = torch.from_numpy(raw)
    return raw.view(dtype).reshape(shape)


class RawSerializer(Serializer):

    def __init__(self, compress_level: Optional[int] = None):
        self.compress_level = compress_level

    def to_bytes(self, blob) -> bytes:
        return encode_array(blob, self.compress_level)


class RawDeserializer(Deserializer):

    def from_bytes(self, bs: bytes) -> torch.Tensor:
        return decode_array(bs)
