"""The ``save_decode_cache`` semantics (the JAX package's
``examples/save_decode_cache.py``).

With ``save_decode_cache`` the engine also stores the KV produced during
decode, so a follow-up request whose prompt holds the previous answer (a
multi-round chat) hits the cache on the generated tokens too.

    python -m lmcache_tpu_torch.examples.save_decode_cache [--device cpu]
"""

import sys

import numpy as np

from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,
                               LMCacheEngineMetadata)
from lmcache_tpu_torch.examples import check, dense_model, device_arg
from lmcache_tpu_torch.serving import SamplingParams, ServingEngine
from lmcache_tpu_torch.utils import resolve_device

PROMPT = 64  # round 1's prompt tokens
ANSWER = 32  # round 1's generated tokens


def run(cfg, params, dev, save_decode: bool) -> int:
    """Round 2's cached prefix length."""
    cache = LMCacheEngine(
        LMCacheEngineConfig.from_defaults(local_device=dev.type,
                                          chunk_size=16,
                                          save_decode_cache=save_decode),
        LMCacheEngineMetadata(model_name=f"tiny-{save_decode}",
                              world_size=1, worker_id=0, fmt="vllm",
                              dtype=cfg.dtype))
    engine = ServingEngine(cfg, params, max_batch=2, max_seq=512,
                           cache_engine=cache,
                           save_decode_cache=save_decode, device=dev)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, PROMPT,
                                               dtype=np.int32)
    try:
        [first] = engine.generate([prompt],
                                  SamplingParams(max_new_tokens=ANSWER))
        cache.engine_.flush()
        # round 2: round 1's prompt + its answer + a new question
        follow_up = np.concatenate([
            prompt, np.asarray(first.output_tokens, np.int32),
            np.random.default_rng(1).integers(0, cfg.vocab_size, 16,
                                              dtype=np.int32)])
        [second] = engine.generate([follow_up],
                                   SamplingParams(max_new_tokens=8))
    finally:
        cache.close()
    return second.cached_prefix_len


def main(device="cuda"):
    dev = resolve_device(device)
    cfg, params = dense_model(dev)
    without = run(cfg, params, dev, False)
    with_ = run(cfg, params, dev, True)
    print(f"round-2 cached prefix: {without} tokens without "
          f"save_decode_cache, {with_} with it")
    check(with_ > without and with_ > PROMPT,
          "round 2 hits the generated tokens with save_decode_cache")
    return {"without": without, "with": with_, "prompt": PROMPT,
            "answer": ANSWER}


if __name__ == "__main__":
    main(device_arg(sys.argv[1:]))
