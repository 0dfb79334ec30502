"""Disaggregated prefill and decode (the JAX package's
``examples/disaggregated_prefill.py``): a PREFILL instance computes and
stores long-context KV; a separate DECODE instance retrieves it and
generates without running the long prefill.

The serving pattern of prefill/decode separation on top of the cache tiers:
the prefill fleet is sized for compute-bound long prefills, the decode
fleet for memory-bound batched decode, and the KV handoff is the cache
engine's store and retrieve over the shared cache server. A chunk stored by
the prefill instance is the wire format; there is no other transfer
protocol.

    python -m lmcache_tpu_torch.examples.disaggregated_prefill [--device cpu]
"""

import sys
import time

import numpy as np

from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,
                               LMCacheEngineMetadata)
from lmcache_tpu_torch.examples import (cache_server, check, dense_model,
                                        device_arg)
from lmcache_tpu_torch.serving import SamplingParams, ServingEngine
from lmcache_tpu_torch.utils import resolve_device

CHUNK = 64  # the tier's chunk
SEGMENT = 256  # every instance's prefill segment
# the context's last token is prefilled alone by the prefill instance and
# by the decode instance after its hit, so the decode instance's tokens
# equal a single instance's own run bit for bit
CONTEXT = SEGMENT + 1
NEW = 16


def make_instance(cfg, params, dev, url, role):
    """An engine of ``role`` over the shared server. The prefill fleet
    publishes the prompt's KV at first-token time (``eager_store``), not at
    the end of the request: decode instances can retrieve it while the
    prefill instance still decodes."""
    cache = LMCacheEngine(
        LMCacheEngineConfig.from_defaults(local_device=dev.type,
                                          remote_url=url, chunk_size=CHUNK),
        LMCacheEngineMetadata(model_name="tiny", world_size=1,
                              worker_id=0, fmt="vllm", dtype=cfg.dtype))
    print(f"[{role}] instance up")
    return ServingEngine(cfg, params, max_batch=2, max_seq=512,
                         cache_engine=cache, prefill_chunk=SEGMENT,
                         eager_store=(role == "prefill"), device=dev), cache


def main(device="cuda", url=None):
    """``url``: a running cache server (default: one started here)."""
    dev = resolve_device(device)
    if url is None:
        with cache_server() as started:
            return main(dev, started)
    cfg, params = dense_model(dev)
    context = np.random.default_rng(0).integers(
        0, cfg.vocab_size, CONTEXT).astype(np.int32)

    # the prefill instance: the context's KV computed once and stored
    pre_eng, pre_cache = make_instance(cfg, params, dev, url, "prefill")
    try:
        t0 = time.perf_counter()
        pre_eng.generate([context], SamplingParams(max_new_tokens=1))
        pre_cache.engine_.flush()  # push the store to the server
        prefill_s = time.perf_counter() - t0
    finally:
        pre_cache.close()
    print(f"[prefill] context prefilled + stored in {prefill_s:.2f}s")

    # the decode instance: a fresh one with no KV of its own
    dec_eng, dec_cache = make_instance(cfg, params, dev, url, "decode")
    try:
        t0 = time.perf_counter()
        [out] = dec_eng.generate([context],
                                 SamplingParams(max_new_tokens=NEW))
        dt = time.perf_counter() - t0
    finally:
        dec_cache.close()
    print(f"[decode] reused {out.cached_prefix_len}/{len(context)} "
          f"context tokens from the prefill instance; generated "
          f"{len(out.output_tokens)} tokens in {dt:.2f}s "
          f"(TTFT {out.ttft_s * 1e3:.0f} ms)")

    # one instance serving the request alone, the reference
    alone = ServingEngine(cfg, params, max_batch=2, max_seq=512,
                          prefill_chunk=SEGMENT, device=dev)
    [ref] = alone.generate([context], SamplingParams(max_new_tokens=NEW))
    check(out.cached_prefix_len > 0, "the decode instance reuses the "
          "prefill instance's KV")
    check(out.output_tokens == ref.output_tokens, "the decode instance's "
          "tokens equal one instance's own run")
    print("decode instance's tokens equal one instance's own run")
    return {"prefill_s": prefill_s, "decode_s": dt,
            "cached_prefix_len": out.cached_prefix_len,
            "context": len(context), "ttft_ms": out.ttft_s * 1e3,
            "tokens": out.output_tokens, "reference": ref.output_tokens}


if __name__ == "__main__":
    main(device_arg(sys.argv[1:]))
