"""CacheBlend for retrieval-augmented prompts (the JAX package's
``examples/rag_blend.py``; non-prefix KV reuse, ``lmcache_tpu_torch/blend.py``).

Three "documents" are cached once, then composed in another order inside a
new prompt; the blender moves their rotary positions and recomputes about
15 % of the tokens instead of prefilling everything. Its logits are held
against a full prefill of the same prompt and against naive reuse (the
cached KV as it is, only the last token recomputed).

    python -m lmcache_tpu_torch.examples.rag_blend [--device cpu]
"""

import sys

import numpy as np
import torch

from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,
                               LMCacheEngineMetadata)
from lmcache_tpu_torch.blend import CacheBlender
from lmcache_tpu_torch.examples import check, dense_model, device_arg
from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.utils import resolve_device

RATIO = 0.15


def _rel(got, want):
    return float((got - want).norm() / want.norm())


def main(device="cuda"):
    dev = resolve_device(device)
    cfg, params = dense_model(dev)
    cache = LMCacheEngine(
        LMCacheEngineConfig.from_defaults(local_device=dev.type),
        LMCacheEngineMetadata(model_name="tiny", world_size=1, worker_id=0,
                              fmt="vllm", dtype=cfg.dtype))
    blender = CacheBlender(cfg, params, cache, recompute_ratio=RATIO)

    rng = np.random.default_rng(0)
    docs = [rng.integers(0, cfg.vocab_size, 48, dtype=np.int32)
            for _ in range(3)]
    try:
        for d in docs:
            blender.store_chunk(d)
        # the RAG prompt: retrieved documents in relevance order + question
        question = rng.integers(0, cfg.vocab_size, 16, dtype=np.int32)
        chunks = [docs[2], docs[0], question]
        logits, _, info = blender.blend(chunks)
        blender.ratio = 0.0  # naive reuse: only the last token recomputed
        naive, _, _ = blender.blend(chunks)
    finally:
        cache.close()
    print(f"blended {info['total_tokens']} tokens from "
          f"{info['num_chunks']} chunks ({info['misses']} misses), "
          f"recomputed only {info['recomputed_tokens']} "
          f"({100 * info['recomputed_tokens'] / info['total_tokens']:.0f}%)")

    # against the true full prefill
    full = np.concatenate(chunks)
    c = llama.new_kv_cache(cfg, 1, len(full), device=dev)
    gl, _ = llama.forward(params, cfg,
                          torch.as_tensor(full, device=dev).long()[None],
                          torch.zeros(1, dtype=torch.int32, device=dev), c,
                          last_logit_only=True)
    g, b = gl[0, -1].float(), logits.float()
    cos = float(g @ b / (g.norm() * b.norm()))
    rel, rel_naive = _rel(b, g), _rel(naive.float(), g)
    print(f"cosine(blended logits, full-prefill logits) = {cos:.4f}; "
          f"rel_l2 {rel:.4f} against naive reuse's {rel_naive:.4f}")
    check(info["misses"] == 1, "only the question misses the cache")
    check(rel < rel_naive, "the blend is closer to the full prefill than "
          "naive reuse")
    return {"cosine": cos, "rel_l2": rel, "rel_l2_naive": rel_naive,
            "recomputed_tokens": info["recomputed_tokens"],
            "total_tokens": info["total_tokens"], "misses": info["misses"]}


if __name__ == "__main__":
    main(device_arg(sys.argv[1:]))
