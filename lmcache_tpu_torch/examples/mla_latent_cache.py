"""Multi-head latent attention serving: the smaller KV cache (the JAX
package's ``examples/mla_latent_cache.py``).

DeepSeek-family (MLA) models cache one shared latent a token instead of
per-head K/V. This example serves an MLA model (random weights:
DeepSeek-V2-Lite at full width and 3 of its 27 layers on the card, its
dense layer and two MoE layers; a tiny MLA model on the CPU; with a
checkpoint, ``mla.load_hf`` reads it), generates twice, and shows the
second request reusing the latent prefix through the cache engine. It also
prints the bytes a token the cache tiers move for MLA against an
equal-scale GQA model (8 KV heads of 128).

    python -m lmcache_tpu_torch.examples.mla_latent_cache [--device cpu]
"""

import dataclasses
import sys
import time

import numpy as np
import torch

from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,
                               LMCacheEngineMetadata)
from lmcache_tpu_torch.examples import check, device_arg, sync
from lmcache_tpu_torch.models import mla
from lmcache_tpu_torch.serving import MLAServingEngine, SamplingParams
from lmcache_tpu_torch.utils import resolve_device

CARD_LAYERS = 3  # V2-Lite's dense layer and two MoE layers
CHUNK = 256  # the tier's chunk and the engine's prefill segment
# the last prompt token is prefilled alone in both requests, so the reuse
# has the first request's shapes and decodes its tokens bit for bit
PROMPT = 2 * CHUNK + 1


def mla_config(device) -> mla.MLAConfig:
    if resolve_device(device).type == "cuda":
        return dataclasses.replace(mla.MLAConfig.deepseek_v2_lite(),
                                   n_layers=CARD_LAYERS)
    return mla.MLAConfig.tiny(n_layers=3, n_routed_experts=4,
                              n_shared_experts=1, n_experts_per_tok=2,
                              moe_hidden_dim=64, first_k_dense_replace=1)


def main(device="cuda"):
    dev = resolve_device(device)
    cfg = mla_config(dev)
    params = mla.init_params(cfg, device=dev)
    cache = LMCacheEngine(
        LMCacheEngineConfig.from_defaults(local_device=dev.type,
                                          chunk_size=CHUNK),
        LMCacheEngineMetadata(model_name="mla-demo", world_size=1,
                              worker_id=0, fmt="vllm", dtype=cfg.dtype))
    engine = MLAServingEngine(cfg, params, max_batch=4, max_seq=1024,
                              cache_engine=cache, prefill_chunk=CHUNK,
                              device=dev)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, PROMPT,
                                               dtype=np.int32)
    sampling = SamplingParams(max_new_tokens=16)
    try:
        t0 = time.perf_counter()
        [first] = engine.generate([prompt], sampling)
        sync(dev)
        t_cold = time.perf_counter() - t0
        cache.engine_.flush()
        t0 = time.perf_counter()
        [again] = engine.generate([prompt], sampling)
        sync(dev)
        t_warm = time.perf_counter() - t0
    finally:
        cache.close()

    itemsize = torch.finfo(mla.torch_dtype(cfg)).bits // 8
    latent_bpt = cfg.n_layers * cfg.latent_dim * itemsize
    # equal-geometry GQA: 2 (K, V) x 8 KV heads x 128
    gqa_bpt = cfg.n_layers * 2 * 8 * 128 * itemsize
    ratio = gqa_bpt / latent_bpt
    print(f"cold {t_cold * 1e3:.0f} ms -> warm {t_warm * 1e3:.0f} ms "
          f"(cached prefix: {again.cached_prefix_len} tokens)")
    print(f"cached bytes/token: MLA latent {latent_bpt} vs equal-scale GQA "
          f"{gqa_bpt} ({ratio:.1f}x smaller -> {ratio:.1f}x more contexts "
          f"per tier)")
    check(again.cached_prefix_len > 0, "the second request hits the cache")
    check(again.output_tokens == first.output_tokens,
          "the reuse decodes the full prefill's tokens")
    return {"cold_ms": t_cold * 1e3, "warm_ms": t_warm * 1e3,
            "cached_prefix_len": again.cached_prefix_len,
            "latent_bytes_per_token": latent_bpt,
            "gqa_bytes_per_token": gqa_bpt, "bytes_ratio": ratio,
            "tokens": [first.output_tokens, again.output_tokens]}


if __name__ == "__main__":
    main(device_arg(sys.argv[1:]))
