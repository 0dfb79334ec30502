"""Prompt-lookup speculative decoding (the JAX package's
``examples/speculative_decode.py``).

A repetitive "document" prompt makes greedy decode copy from its own
context; ``spec_lookahead`` verifies several proposed tokens in one forward
instead of one step each, and gives greedy decode's tokens.

The model is the in-repo trained dense quality checkpoint
(``tools/quality_common.py``: it copies what it has seen), in bf16 on the
card and fp32 on the CPU. Random weights copy nothing: on tinyllama-1.1B's
the n-gram proposals are rejected, and in bf16 a verification, which
computes in other shapes than a single step, flips near-tied tokens.

    python -m lmcache_tpu_torch.examples.speculative_decode [--device cpu]
"""

import sys
import time

import numpy as np

from lmcache_tpu_torch.examples import check, device_arg, sync
from lmcache_tpu_torch.serving import Request, SamplingParams, ServingEngine
from lmcache_tpu_torch.tools import quality_common as qc
from lmcache_tpu_torch.utils import resolve_device


def serve(engine, prompt, sampling):
    """(the request, the engine steps it took, seconds)."""
    req = engine.add_request(Request(prompt, sampling))
    steps = 0
    t0 = time.perf_counter()
    while engine.has_work():
        engine.step()
        steps += 1
    sync(engine.device)
    return req, steps, time.perf_counter() - t0


def main(device="cuda"):
    dev = resolve_device(device)
    cfg = qc.quality_config("bfloat16" if dev.type == "cuda" else "float32")
    params = qc.load_params(cfg, device=dev)
    # a repetitive "document" of distinct tokens (the copy corpus's rows)
    # so that the n-gram proposer finds matches
    phrase = np.random.default_rng(0).permutation(qc.VOCAB)[:24]
    prompt = np.concatenate([phrase, phrase, phrase[:10]]).astype(np.int32)
    sp = SamplingParams(max_new_tokens=48)

    plain = ServingEngine(cfg, params, max_batch=1, max_seq=512, device=dev)
    a, steps_plain, t_plain = serve(plain, prompt, sp)
    spec = ServingEngine(cfg, params, max_batch=1, max_seq=512, device=dev,
                         spec_lookahead=4)
    b, steps_spec, t_spec = serve(spec, prompt, sp)

    check(a.output_tokens == b.output_tokens, "speculation is exact")
    print(f"tokens generated : {len(b.output_tokens)} (identical outputs)")
    print(f"proposed/accepted: {b.spec_proposed}/{b.spec_accepted}")
    print(f"engine steps     : {steps_plain} plain, {steps_spec} spec")
    print(f"plain   : {t_plain * 1e3:7.1f} ms")
    print(f"spec    : {t_spec * 1e3:7.1f} ms (each accepted token saves "
          f"one forward)")
    return {"tokens": b.output_tokens, "proposed": b.spec_proposed,
            "accepted": b.spec_accepted, "steps_plain": steps_plain,
            "steps_spec": steps_spec, "plain_ms": t_plain * 1e3,
            "spec_ms": t_spec * 1e3}


if __name__ == "__main__":
    main(device_arg(sys.argv[1:]))
