"""KV-blob layout helpers.

The canonical unit flowing through every layer is a single "blob" holding
all layers' K and V for a run of tokens (reference convention,
lmcache/cache_engine.py:98-161):

- ``"vllm"`` format:
  ``[num_layers, 2, num_tokens, num_kv_heads, head_size]``
- ``"huggingface"`` format:
  ``[num_layers, 2, num_kv_heads, num_tokens, head_size]``

These helpers work on numpy arrays and torch tensors (CPU or CUDA) alike,
without moving data between devices. Slices are views: a tier that keeps a
chunk copies it (storage/local_backend.py).
"""

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]
KVTuples = Tuple[Tuple[Array, Array], ...]


def _xp(arr: Array):
    """numpy for numpy arrays, torch for tensors."""
    if isinstance(arr, np.ndarray):
        return np
    return torch


def token_axis(fmt: str) -> int:
    """Token axis within the 5-D blob."""
    if fmt == "vllm":
        return 2
    if fmt == "huggingface":
        return 3
    raise ValueError(f"Invalid format: {fmt}")


def num_tokens_in_blob(blob: Array, fmt: str) -> int:
    return blob.shape[token_axis(fmt)]


def tuple_to_blob(kv: KVTuples) -> Array:
    """Nested per-layer (K, V) tuples -> one [L, 2, ...] blob."""
    xp = _xp(kv[0][0])
    ks = xp.stack([layer[0] for layer in kv])
    vs = xp.stack([layer[1] for layer in kv])
    return xp.stack((ks, vs), 1)  # [L, 2, ...]


def blob_to_tuple(blob: Array) -> KVTuples:
    """One [L, 2, ...] blob -> nested per-layer (K, V) tuples (views)."""
    return tuple((blob[i, 0], blob[i, 1]) for i in range(blob.shape[0]))


def slice_blob_tokens(blob: Array, fmt: str, start: int,
                      end: int = None) -> Array:
    """Slice the blob along the token axis: ``blob[..., start:end, ...]``."""
    axis = token_axis(fmt)
    idx = [slice(None)] * blob.ndim
    idx[axis] = slice(start, end)
    return blob[tuple(idx)]


def chunk_blob(blob: Array, fmt: str, chunk_size: int,
               start: int = 0) -> List[Array]:
    """Split the blob into chunk_size-token pieces starting at ``start``.

    The last piece may be shorter. Pieces are views; the storage tier
    copies what it keeps.
    """
    n = num_tokens_in_blob(blob, fmt)
    return [
        slice_blob_tokens(blob, fmt, i, min(i + chunk_size, n))
        for i in range(start, n, chunk_size)
    ]


def concat_blobs(blobs: Sequence[Array], fmt: str) -> Array:
    if _xp(blobs[0]) is np:
        return np.concatenate(list(blobs), axis=token_axis(fmt))
    return torch.cat(list(blobs), dim=token_axis(fmt))

