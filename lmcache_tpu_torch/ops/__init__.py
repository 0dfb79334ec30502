"""Attention for the port: hand-written Hopper kernels with plain PyTorch
versions beside them. The paged entry points live in
:mod:`lmcache_tpu_torch.ops.paged_attention` (not re-exported here: one of
them carries the module's name)."""

from lmcache_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_dma,
                                             mha_reference)
from lmcache_tpu_torch.ops.quantized_attention import (
    dequantize_kv, quantize_kv_for_cache, quantized_attention_reference,
    quantized_flash_attention)

__all__ = ["flash_attention", "flash_attention_dma", "mha_reference",
           "dequantize_kv", "quantize_kv_for_cache",
           "quantized_attention_reference", "quantized_flash_attention"]
