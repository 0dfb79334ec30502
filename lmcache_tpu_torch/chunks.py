"""Token chunking and rolling prefix hashing.

The chunk is the unit of caching: fixed ``chunk_size`` runs of token ids,
each addressed by a rolling hash of (prefix_hash, chunk_tokens) so that a
chunk's identity commits to its entire prefix (reference semantics:
lmcache/cache_engine.py:55-96).

A copy of ``lmcache_tpu/chunks.py``: the same tokens give byte-identical
hashes, so both packages address the same chunks. Hashing is a host-side
scalar op, so tokens are normalized to host numpy once per call (one device
sync at most), and chunk hashes are computed in a single pass.
"""

import hashlib
from typing import List, Sequence, Union

import numpy as np
import torch

TokenArray = Union[np.ndarray, Sequence[int], torch.Tensor]

_INIT_HASH = ""


def tokens_to_numpy(tokens: TokenArray) -> np.ndarray:
    """Normalize tokens to a flat int32 numpy array (single host sync)."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.detach().cpu().numpy()
    arr = np.asarray(tokens)
    if arr.ndim != 1:
        raise ValueError(f"Expected 1-D tokens, got shape {arr.shape}")
    return np.ascontiguousarray(arr, dtype=np.int32)


def prefix_chunk_hashes(
    tokens: TokenArray,
    chunk_size: int,
    num_skip_chunk: int = 0,
) -> List[str]:
    """Rolling hash per chunk: ``h_i = H(h_{i-1} || tokens_i)``.

    Returns one hex digest per chunk (including a trailing partial chunk),
    skipping the first ``num_skip_chunk`` results.
    """
    arr = tokens_to_numpy(tokens)
    hashes: List[str] = []
    prefix = _INIT_HASH
    for start in range(0, len(arr), chunk_size):
        h = hashlib.sha256()
        h.update(prefix.encode("ascii"))
        h.update(arr[start:start + chunk_size].tobytes())
        prefix = h.hexdigest()
        hashes.append(prefix)
    return hashes[num_skip_chunk:]


def hash_tokens(tokens: TokenArray) -> str:
    """Position-independent content hash of a token run.

    Used by CacheBlend: unlike the rolling prefix
    hash, the same text chunk maps to the same key at any position in any
    prompt — the enabler of non-prefix reuse.
    """
    arr = tokens_to_numpy(tokens)
    h = hashlib.sha256()
    h.update(b"blend:")
    h.update(arr.tobytes())
    return h.hexdigest()


def num_chunks(num_tokens: int, chunk_size: int) -> int:
    return -(-num_tokens // chunk_size)
