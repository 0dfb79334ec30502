"""Lossless serde with a self-describing binary container.

Port of ``lmcache_tpu/storage/serde/raw_serde.py``: the same container, byte
for byte, so either package reads what the other wrote. bfloat16 travels as
its raw bytes (``tensor.view(torch.uint8)``), with no ``ml_dtypes``.

Container layout (little endian):

    magic   4s   b"LMTC"
    version u8   = 1
    flags   u8   bit0: zstd-compressed payload (not ported: raises)
    ndim    u8
    dlen    u8   length of dtype-name string
    nbytes  u64  payload byte length (uncompressed)
    shape   u64 * ndim
    dtype   dlen ascii bytes (numpy dtype name, e.g. "bfloat16")
    payload raw array bytes

A decoded blob is a CPU tensor (the JAX package returns a numpy array): the
consumer moves it to its device.
"""

import struct

import numpy as np
import torch

from lmcache_tpu_torch.storage.serde.serde import Deserializer, Serializer

MAGIC = b"LMTC"
VERSION = 1
_HDR = struct.Struct("<4sBBBBQ")
_FLAG_ZSTD = 1
_ZSTD = "raw_zstd is not ported yet (ROADMAP, module item 8)"


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("bfloat16", "float32", ...)."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"Unknown dtype in container: {name!r}")
    return dtype


def encode_array(blob) -> bytes:
    t = torch.as_tensor(blob).detach().contiguous().cpu()
    name = dtype_name(t.dtype).encode("ascii")
    payload = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    header = _HDR.pack(MAGIC, VERSION, 0, t.dim(), len(name), len(payload))
    shape = struct.pack(f"<{t.dim()}Q", *t.shape)
    return header + shape + name + payload


def decode_array(bs) -> torch.Tensor:
    magic, version, flags, ndim, dlen, nbytes = _HDR.unpack_from(bs, 0)
    if magic != MAGIC:
        raise ValueError("Not an LMTC container")
    if version != VERSION:
        raise ValueError(f"Unsupported container version {version}")
    if flags & _FLAG_ZSTD:
        raise NotImplementedError(_ZSTD)
    off = _HDR.size
    shape = struct.unpack_from(f"<{ndim}Q", bs, off)
    off += 8 * ndim
    dtype = torch_dtype(bytes(bs[off:off + dlen]).decode("ascii"))
    off += dlen
    if len(bs) - off != nbytes:
        raise ValueError(f"Corrupt LMTC container: {len(bs) - off} payload "
                         f"bytes, header says {nbytes}")
    raw = np.frombuffer(bs, np.uint8, nbytes, off)
    if not raw.flags.writeable:  # bytes (a native GET's buffer is taken)
        raw = raw.copy()
    raw = torch.from_numpy(raw)
    return raw.view(dtype).reshape(shape)


class RawSerializer(Serializer):

    def to_bytes(self, blob) -> bytes:
        return encode_array(blob)


class RawDeserializer(Deserializer):

    def from_bytes(self, bs: bytes) -> torch.Tensor:
        return decode_array(bs)
