"""Offline inference with KV reuse (the JAX package's
``examples/offline_inference.py``).

Generates twice with the same long prompt; the second request retrieves the
prefix KV from the cache tier, prefills only its last token, and decodes
the same greedy tokens.

    python -m lmcache_tpu_torch.examples.offline_inference [--device cpu]
"""

import sys
import time

import numpy as np

from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,
                               LMCacheEngineMetadata)
from lmcache_tpu_torch.examples import (check, dense_config, dense_model,
                                        device_arg)
from lmcache_tpu_torch.serving import SamplingParams, ServingEngine
from lmcache_tpu_torch.utils import resolve_device


CHUNK = 256  # the tier's chunk (the default)
# the engine prefills in segments of 512 tokens: a prompt of two chunks and
# one token has its last token prefilled alone, as the second request
# prefills it after its cache hit, so both decode the same tokens bit for bit
PROMPT = 2 * CHUNK + 1


def main(device="cuda", params=None):
    """Serve the prompt twice; ``params`` are the weights of
    :func:`dense_config`'s model (default: drawn from seed 0)."""
    dev = resolve_device(device)
    if params is None:
        cfg, params = dense_model(dev)
    else:
        cfg = dense_config(dev)
    cache = LMCacheEngine(
        LMCacheEngineConfig.from_defaults(local_device=dev.type,
                                          chunk_size=CHUNK),
        LMCacheEngineMetadata(model_name="tinyllama-1.1b", world_size=1,
                              worker_id=0, fmt="vllm", dtype=cfg.dtype))
    engine = ServingEngine(cfg, params, max_batch=4, max_seq=1024,
                           cache_engine=cache, device=dev)

    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, PROMPT,
                                               dtype=np.int32)
    sampling = SamplingParams(max_new_tokens=32)
    try:
        t0 = time.perf_counter()
        [first] = engine.generate([prompt], sampling)
        print(f"1st request: ttft={first.ttft_s * 1e3:.1f}ms "
              f"cached_prefix={first.cached_prefix_len} "
              f"wall={time.perf_counter() - t0:.2f}s")
        cache.engine_.flush()  # the store-back is non-blocking

        t0 = time.perf_counter()
        [second] = engine.generate([prompt], sampling)
        print(f"2nd request: ttft={second.ttft_s * 1e3:.1f}ms "
              f"cached_prefix={second.cached_prefix_len} "
              f"wall={time.perf_counter() - t0:.2f}s")
    finally:
        cache.close()
    check(second.cached_prefix_len > 0, "the second request hits the cache")
    check(first.output_tokens == second.output_tokens,
          "both requests decode the same tokens")
    speedup = first.ttft_s / second.ttft_s
    print(f"outputs identical; speedup {speedup:.2f}x TTFT")
    return {"ttft_ms": [first.ttft_s * 1e3, second.ttft_s * 1e3],
            "cached_prefix_len": [first.cached_prefix_len,
                                  second.cached_prefix_len],
            "tokens": [first.output_tokens, second.output_tokens],
            "speedup": speedup}


if __name__ == "__main__":
    main(device_arg(sys.argv[1:]))
