"""Serving-engine integration hooks (the reference's L0 contract), over the
port's cache engine: the port of ``lmcache_tpu/integration.py``.

The hook API the reference documents for wiring any LLM engine to the cache
(reference docs/source/developer_tutorial/LLM_Engine.rst:25-133):
``init_lmcache_engine / close_lmcache_engine / lmcache_should_retrieve /
lmcache_should_store / lmcache_retrieve_kv / lmcache_store_kv /
build_partial_prefill_input``, plus ``lmcache_retrieve_kv_stream``, a
chunk-streaming retrieval the blob-shaped hook cannot express (inject while
fetching; see its docstring).

The in-repo serving engines (``lmcache_tpu_torch.serving``) use the
``LMCacheEngine`` directly; this module is for *outside* PyTorch serving
loops that want the same drop-in shape. The "model input" is the
framework-neutral :class:`StepInput`: its ``tokens`` a numpy int32 array,
its ``retrieved_kv`` a torch blob on the cache engine's device.
"""

import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from lmcache_tpu_torch import kv
from lmcache_tpu_torch.cache_engine import LMCacheEngine, LMCacheEngineBuilder
from lmcache_tpu_torch.config import (LMCacheEngineConfig,
                                      LMCacheEngineMetadata)
from lmcache_tpu_torch.logging_utils import init_logger

logger = init_logger(__name__)

ENGINE_NAME = "vllm-instance"  # reference default instance id
_CONFIG_ENV = "LMCACHE_CONFIG_FILE"  # reference README.md:55-58


@dataclass(frozen=True)
class StepInput:
    """Framework-neutral description of one forward step of one sequence."""

    tokens: np.ndarray  # int32 [T] full token ids
    is_prefill: bool
    is_profile_run: bool = False
    # number of leading tokens whose KV is already in the engine's buffer
    num_computed_tokens: int = 0
    # KV retrieved from the cache, vllm-fmt blob [L, 2, t, H, D] (or None),
    # a torch tensor on the cache engine's device
    retrieved_kv: Optional[object] = None


def init_lmcache_engine(
    model_name: str,
    world_size: int = 1,
    worker_id: int = 0,
    fmt: str = "vllm",
    dtype: str = "bf16",
    config: Optional[LMCacheEngineConfig] = None,
) -> Optional[LMCacheEngine]:
    """Create the process-wide engine (None if it already exists).

    Config resolution order: explicit ``config`` arg, the YAML file named by
    $LMCACHE_CONFIG_FILE, then defaults (the ``"cuda"`` tier).
    """
    if LMCacheEngineBuilder.get(ENGINE_NAME) is not None:
        return None
    if config is None:
        path = os.environ.get(_CONFIG_ENV)
        config = (LMCacheEngineConfig.from_file(path)
                  if path else LMCacheEngineConfig.from_defaults())
    metadata = LMCacheEngineMetadata(model_name=model_name,
                                     world_size=world_size,
                                     worker_id=worker_id, fmt=fmt,
                                     dtype=dtype)
    return LMCacheEngineBuilder.get_or_create(ENGINE_NAME, config, metadata)


def close_lmcache_engine() -> None:
    LMCacheEngineBuilder.destroy(ENGINE_NAME)


def _engine() -> Optional[LMCacheEngine]:
    return LMCacheEngineBuilder.get(ENGINE_NAME)


def lmcache_should_retrieve(step: StepInput) -> bool:
    """Retrieve only for real (non-profiling) prefill steps with an
    initialized engine (reference semantics)."""
    return (_engine() is not None and step.is_prefill
            and not step.is_profile_run and step.num_computed_tokens == 0)


def lmcache_should_store(step: StepInput) -> bool:
    engine = _engine()
    if engine is None or step.is_profile_run:
        return False
    return step.is_prefill or engine.save_decode_cache


def lmcache_retrieve_kv(step: StepInput) -> StepInput:
    """Pull the longest cached prefix and rebuild the step so only the
    uncached suffix is prefilled (``build_partial_prefill_input`` rolled
    in). The prefix comes back as one blob; :func:`lmcache_retrieve_kv_stream`
    hands it over chunk by chunk instead."""
    engine = _engine()
    blob, mask = engine.retrieve(step.tokens, return_tuple=False)
    hit = int(np.asarray(mask).sum())
    # always leave >= 1 token to recompute so the step produces logits
    hit = min(hit, len(step.tokens) - 1)
    if hit <= 0:
        return step
    return replace(step, num_computed_tokens=hit,
                   retrieved_kv=kv.slice_blob_tokens(
                       blob, engine.metadata.fmt, 0, hit))


def lmcache_retrieve_kv_stream(step: StepInput):
    """Streaming variant of :func:`lmcache_retrieve_kv`: yields
    ``(start_token, chunk_blob)`` pieces of the cached prefix as they
    arrive (``LMCacheEngine.retrieve_stream``), so an outside serving loop
    can inject chunk k into its KV buffer while chunk k+1 is still being
    fetched or decoded, instead of paying a prefix-sized concatenation
    before the first injection.

    The final piece may be cut short so >= 1 token is always left to
    recompute. Consume to exhaustion, then prefill
    ``step.tokens[sum(lengths):]``; or ``close()`` the generator to cancel
    in-flight fetches.
    """
    engine = _engine()
    fmt = engine.metadata.fmt
    limit = len(step.tokens) - 1  # leave >= 1 token to recompute
    for chunk, start_tok, num_toks in engine.retrieve_stream(step.tokens):
        # the stream may carry undecoded host chunks (cachegen); outside
        # consumers get plain tensors
        if start_tok + num_toks >= limit:
            keep = limit - start_tok
            if keep > 0:
                chunk = kv.slice_blob_tokens(chunk, fmt, 0, keep)
                yield start_tok, kv.ensure_blob(chunk, fmt)
            return
        yield start_tok, kv.ensure_blob(chunk, fmt)


def build_partial_prefill_input(step: StepInput) -> np.ndarray:
    """Tokens that still need the forward pass."""
    return step.tokens[step.num_computed_tokens:]


def lmcache_store_kv(step: StepInput, kv_blob) -> None:
    """Store the step's KV (vllm-fmt [L, 2, T, H, D]) without blocking the
    decode loop: the tier copies the chunks (views of ``kv_blob``) before
    this returns and writes them on its put worker."""
    engine = _engine()
    engine.store(step.tokens, kv_blob, blocking=False)
