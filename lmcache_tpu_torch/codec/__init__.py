"""CacheGen KV-cache codec: the per-layer bin schedule and the host range
coder (a copy of ``lmcache_tpu/codec``).

Quantization, CDF estimation and dequantization are torch ops
(:mod:`lmcache_tpu_torch.ops.quant`); the range coders that run on the card
are :mod:`lmcache_tpu_torch.ops.range_encode` and
:mod:`lmcache_tpu_torch.ops.range_decode`. The host C++ coder here
(``csrc/lmtc_codec.cc``, OpenMP, one independent stream per row) is the
``cachegen_device_{en,de}code="off"`` path and the reference they are held
to.
"""

from lmcache_tpu_torch.codec.cachegen_config import CacheGenConfig
from lmcache_tpu_torch.codec.range_coder import (codec_available,
                                                 decode_streams,
                                                 encode_streams)

__all__ = [
    "encode_streams", "decode_streams", "codec_available", "CacheGenConfig"
]
