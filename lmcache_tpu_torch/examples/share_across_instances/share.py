"""Two serving instances sharing one cache server (see README.md; the JAX
package's ``examples/share_across_instances/share.py``).

    python -m lmcache_tpu_torch.examples.share_across_instances.share \\
        [--device cpu]
"""

import sys

import numpy as np

from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,
                               LMCacheEngineMetadata)
from lmcache_tpu_torch.examples import (cache_server, check, dense_model,
                                        device_arg)
from lmcache_tpu_torch.serving import SamplingParams, ServingEngine
from lmcache_tpu_torch.utils import resolve_device

CHUNK = 256  # the tier's chunk; each instance prefills in segments of it
# A prefills the prompt's last token alone, as B does after its cache hit
# (an engine prefills up to the last prompt token from the cache), so
# every product of B has A's shapes and the tokens agree bit for bit
PROMPT = CHUNK + 1


def make_instance(cfg, params, dev, url):
    """An engine whose tier is the local one in front of the shared server
    (the hybrid tier), prefilling in segments of ``CHUNK`` tokens."""
    cache = LMCacheEngine(
        LMCacheEngineConfig.from_defaults(local_device=dev.type,
                                          remote_url=url, chunk_size=CHUNK),
        LMCacheEngineMetadata(model_name="tiny", world_size=1, worker_id=0,
                              fmt="vllm", dtype=cfg.dtype))
    return ServingEngine(cfg, params, max_batch=2, max_seq=512,
                         cache_engine=cache, prefill_chunk=CHUNK,
                         device=dev), cache


def main(device="cuda", url=None):
    """``url``: a running cache server (default: one started here)."""
    dev = resolve_device(device)
    if url is None:
        with cache_server() as started:
            return main(dev, started)
    cfg, params = dense_model(dev)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, PROMPT,
                                               dtype=np.int32)
    sampling = SamplingParams(max_new_tokens=16)

    inst_a, cache_a = make_instance(cfg, params, dev, url)
    try:
        [ra] = inst_a.generate([prompt], sampling)
        cache_a.engine_.flush()
    finally:
        cache_a.close()
    print(f"instance A: ttft={ra.ttft_s * 1e3:.1f}ms "
          f"cached={ra.cached_prefix_len}")

    inst_b, cache_b = make_instance(cfg, params, dev, url)  # a fresh one
    try:
        [rb] = inst_b.generate([prompt], sampling)
    finally:
        cache_b.close()
    print(f"instance B: ttft={rb.ttft_s * 1e3:.1f}ms "
          f"cached={rb.cached_prefix_len}  (prefilled by A)")
    check(rb.cached_prefix_len > 0, "instance B hits what A stored")
    check(ra.output_tokens == rb.output_tokens,
          "both instances decode the same tokens")
    print("identical outputs across instances")
    return {"ttft_ms": [ra.ttft_s * 1e3, rb.ttft_s * 1e3],
            "cached_prefix_len": [ra.cached_prefix_len, rb.cached_prefix_len],
            "tokens": [ra.output_tokens, rb.output_tokens]}


if __name__ == "__main__":
    main(device_arg(sys.argv[1:]))
