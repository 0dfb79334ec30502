"""Attention for the port: hand-written Hopper kernels with plain PyTorch
versions beside them."""

from lmcache_tpu_torch.ops.attention import flash_attention, mha_reference

__all__ = ["flash_attention", "mha_reference"]
