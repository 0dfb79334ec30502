"""Attention for the port: hand-written Hopper kernels with plain PyTorch
versions beside them. The paged entry points live in
:mod:`lmcache_tpu_torch.ops.paged_attention` (not re-exported here: one of
them carries the module's name)."""

from lmcache_tpu_torch.ops.attention import flash_attention, mha_reference

__all__ = ["flash_attention", "mha_reference"]
