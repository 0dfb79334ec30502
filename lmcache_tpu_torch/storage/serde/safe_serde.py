"""Lossless serde over the safetensors container.

Port of ``lmcache_tpu/storage/serde/safe_serde.py``: one tensor under the
name ``"kv"``, written through safetensors' numpy backend, so either package
reads what the other wrote. That backend has no bfloat16 or float8, so such
a payload is bit-cast to an unsigned integer of its width, and the true
dtype is kept in the header's metadata (``"true_dtype"``).

``safetensors`` is imported where it is used: without it, either direction
raises ``ImportError``. A decoded blob is a CPU tensor.
"""

import json
import struct

import numpy as np
import torch

from lmcache_tpu_torch.storage.serde.raw_serde import dtype_name, torch_dtype
from lmcache_tpu_torch.storage.serde.serde import Deserializer, Serializer

_KEY = "kv"
# dtype name -> (torch dtype of its bits, numpy dtype they are stored as)
_BITCAST = {
    "bfloat16": (torch.int16, np.uint16),
    "float8_e4m3fn": (torch.uint8, np.uint8),
    "float8_e5m2": (torch.uint8, np.uint8),
}


def _safetensors_numpy():
    try:
        import safetensors.numpy as st
    except ImportError as e:
        raise ImportError("the safetensors serde needs the safetensors "
                          "package (pip install safetensors)") from e
    return st


class SafeSerializer(Serializer):

    def to_bytes(self, blob) -> bytes:
        st = _safetensors_numpy()
        t = torch.as_tensor(blob).detach().contiguous().cpu()
        name = dtype_name(t.dtype)
        meta = None
        if name in _BITCAST:
            bits, stored = _BITCAST[name]
            meta = {"true_dtype": name}
            arr = t.view(bits).numpy().view(stored)
        else:
            arr = t.numpy()
        return st.save({_KEY: arr}, metadata=meta)


class SafeDeserializer(Deserializer):

    def from_bytes(self, bs) -> torch.Tensor:
        st = _safetensors_numpy()
        bs = bytes(bs)
        arr = np.array(st.load(bs)[_KEY])  # a private, writable copy
        # the numpy loader drops the metadata: read the header for it
        (hlen, ) = struct.unpack_from("<Q", bs, 0)
        meta = json.loads(bs[8:8 + hlen]).get("__metadata__") or {}
        true_dtype = meta.get("true_dtype")
        t = torch.from_numpy(arr)
        if true_dtype:
            bits, _ = _BITCAST[true_dtype]
            t = t.view(bits).view(torch_dtype(true_dtype))
        return t
