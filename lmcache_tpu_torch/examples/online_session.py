"""An online serving session (the JAX package's
``examples/online_session.py``).

Starts the OpenAI-compatible API server (``serving/api.py``) and drives a
short multi-round session against it: every round resends the growing
conversation (the replies and the user's next turns) as text, so each
request after the first hits the KV cache, and
``usage.prompt_tokens_details.cached_tokens`` climbs.

    python -m lmcache_tpu_torch.examples.online_session [--device cpu]
    python -m lmcache_tpu_torch.examples.online_session --serve --port 8377

``--serve`` only serves, for ``chat_client.py`` and ``frontend/serve.py``.
"""

import argparse
import json
import sys
import urllib.request

from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,
                               LMCacheEngineMetadata)
from lmcache_tpu_torch.examples import check, dense_model
from lmcache_tpu_torch.examples.demo_tokenizer import get_tokenizer
from lmcache_tpu_torch.serving import ServingEngine
from lmcache_tpu_torch.serving.api import APIServer
from lmcache_tpu_torch.utils import resolve_device

HISTORY = ("the quick brown fox jumps over the lazy dog and the cache holds "
           "the keys and values of every token")
# the user's next turn, appended after each reply: the conversation grows
# by at least a chunk a round whatever the reply's text (a random model's
# tokens outside the tokenizer's vocabulary decode to nothing)
TURNS = ("reuse the prefix compute only the suffix and the first token is "
         "fast and all that glitters is not gold",
         "pages hold the cache chunks hash the tokens servers share the store "
         "and a journey of a thousand miles begins with a single step")


def make_server(device="cuda"):
    """(the API server over a dense engine with a cache tier of chunks of
    16 tokens, the tier): multi-round prompts grow by tens of tokens, so
    small chunks let each round's prefix hit. The server speaks text
    through :func:`demo_tokenizer.get_tokenizer`."""
    dev = resolve_device(device)
    cfg, params = dense_model(dev)
    cache = LMCacheEngine(
        LMCacheEngineConfig.from_defaults(local_device=dev.type,
                                          chunk_size=16),
        LMCacheEngineMetadata(model_name="tiny", world_size=1, worker_id=0,
                              fmt="vllm", dtype=cfg.dtype))
    engine = ServingEngine(cfg, params, max_batch=4, max_seq=512,
                           cache_engine=cache, save_decode_cache=True,
                           device=dev)
    tok = get_tokenizer(cfg.vocab_size)
    return APIServer(engine, model_name="tiny-session", tokenizer=tok.encode,
                     detokenizer=tok.decode), cache


def post(base: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def main(device="cuda", rounds=3, max_tokens=16):
    server, cache = make_server(device)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.listen('127.0.0.1', 0)}"
        history, cached, prompt_tokens, ttft = HISTORY, [], [], []
        for round_ in range(rounds):
            r = post(base, "/v1/completions",
                     {"prompt": history, "max_tokens": max_tokens})
            # the store-back is non-blocking: wait for it (no step in
            # flight, the tier flushed) so that the next round can hit
            with server._lock:
                cache.engine_.flush()
            usage = r["usage"]
            cached.append(usage["prompt_tokens_details"]["cached_tokens"])
            prompt_tokens.append(usage["prompt_tokens"])
            ttft.append(usage["ttft_ms"])
            print(f"round {round_}: ttft={usage['ttft_ms']}ms "
                  f"cached_tokens={cached[-1]}/{prompt_tokens[-1]}")
            # the conversation grows by the reply and the next turn
            history += r["choices"][0]["text"] + " " + TURNS[
                round_ % len(TURNS)]
    finally:
        server.stop()
        cache.close()
    check(all(b > a for a, b in zip(cached, cached[1:])),
          "cached_tokens climbs over the rounds")
    return {"cached_tokens": cached, "prompt_tokens": prompt_tokens,
            "ttft_ms": ttft}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--serve", action="store_true",
                    help="serve until interrupted instead of a session")
    ap.add_argument("--port", type=int, default=8377)
    args = ap.parse_args()
    if args.serve:
        srv, tier = make_server(args.device)
        try:
            srv.run("localhost", args.port)
        finally:
            tier.close()
        sys.exit(0)
    main(args.device)
