"""The port's examples (``lmcache_tpu_torch/examples``) on the CPU, each at
its tiny config, with the claims that ``chip_smoke.py`` phase 20 holds on
the card; offline inference against the JAX example's engine on the same
weights, and the port's YAML gallery against the JAX gallery."""

import glob
import http.server
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

import lmcache_tpu as jpkg
from lmcache_tpu.models import llama as jllama
from lmcache_tpu.serving import SamplingParams as JSamplingParams
from lmcache_tpu.serving import ServingEngine as JServingEngine
from lmcache_tpu_torch import LMCacheEngineConfig
from lmcache_tpu_torch.examples import (cache_server, chat_client,
                                        disaggregated_prefill,
                                        mla_latent_cache, offline_inference,
                                        online_session, rag_blend,
                                        save_decode_cache,
                                        speculative_decode)
from lmcache_tpu_torch.examples.frontend import serve as frontend
from lmcache_tpu_torch.examples.share_across_instances import share
from lmcache_tpu_torch.examples.storage_backends import round_trip
from lmcache_tpu_torch.models import llama

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_GALLERY = sorted(glob.glob(os.path.join(
    ROOT, "lmcache_tpu_torch", "examples", "storage_backends", "*.yaml")))
JAX_GALLERY = os.path.join(ROOT, "examples", "storage_backends")
CONFIG_FIELDS = ("chunk_size", "remote_url", "remote_serde",
                 "pipelined_backend", "save_decode_cache",
                 "local_capacity_bytes", "blend_recompute_ratio",
                 "cachegen_device_decode", "cachegen_device_encode",
                 "hybrid_prefetch_chunks", "hybrid_prefetch_bytes",
                 "hybrid_prefetch_async")


# every test of this file on one torch thread (an autouse fixture)
from torch_test_helpers import one_torch_thread  # noqa: E402,F401


def test_offline_inference_reuses_and_matches_the_jax_example():
    """The port's example on the JAX example's weights (``init_params`` of
    seed 0, carried across) gives the JAX engine's greedy tokens, twice."""
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jax.random.PRNGKey(0), cfg)
    cache = jpkg.LMCacheEngine(
        jpkg.LMCacheEngineConfig.from_defaults(local_device="cpu"),
        jpkg.LMCacheEngineMetadata(model_name="tinyllama-1.1b",
                                   world_size=1, worker_id=0, fmt="vllm",
                                   dtype=cfg.dtype))
    engine = JServingEngine(cfg, jparams, max_batch=4, max_seq=1024,
                            cache_engine=cache)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, offline_inference.PROMPT, dtype=np.int32)
    [want] = engine.generate([prompt], JSamplingParams(max_new_tokens=32))
    cache.close()

    params = llama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   llama.LlamaConfig.tiny(), device="cpu")
    out = offline_inference.main("cpu", params=params)
    assert out["cached_prefix_len"][0] == 0 < out["cached_prefix_len"][1]
    assert out["tokens"][0] == out["tokens"][1] == want.output_tokens


def test_save_decode_cache_hits_the_generated_tokens():
    out = save_decode_cache.main("cpu")
    assert out["without"] <= out["prompt"] < out["with"]


def test_online_session_cached_tokens_climb():
    out = online_session.main("cpu")
    assert out["cached_tokens"][0] == 0
    assert all(b > a for a, b in zip(out["cached_tokens"],
                                     out["cached_tokens"][1:]))
    assert all(c < p for c, p in zip(out["cached_tokens"],
                                     out["prompt_tokens"]))


@pytest.fixture(scope="module")
def api_server():
    server, cache = online_session.make_server("cpu")
    server.start()
    port = server.listen("127.0.0.1", 0)
    yield server, cache, f"http://127.0.0.1:{port}"
    server.stop()
    cache.close()


def test_chat_client_streams_and_climbs(api_server, capsys):
    """The client's rounds, each waiting for the server's store-back of
    the one before (no step in flight, the tier flushed), as the REPL
    builds the conversation: cached tokens climb; ``chat`` prints the
    streamed reply and the usage line."""
    server, cache, base = api_server
    history, cached = "", []
    for line in (online_session.HISTORY, "jumps over the lazy dog",
                 "and the cache holds the keys"):
        history += ("\n" if history else "") + line
        pieces = []
        reply, usage = chat_client.complete(base, history, 8,
                                            out=pieces.append)
        with server._lock:
            cache.engine_.flush()
        assert reply == "".join(pieces)
        cached.append(usage["prompt_tokens_details"]["cached_tokens"])
        history += reply
    assert cached[0] == 0 and cached[1] > 0 and cached[2] > cached[1]
    [r] = chat_client.chat(base, ["the lazy dog"], max_tokens=4)
    text = capsys.readouterr().out
    assert r["reply"] in text and f"[cached {r['cached_tokens']}/" in text


def test_frontend_serves_the_page_and_proxies(api_server):
    _, _, base = api_server
    proxy = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                            frontend.make_handler(base))
    thread = threading.Thread(target=proxy.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{proxy.server_address[1]}"
        with urllib.request.urlopen(url + "/", timeout=30) as r:
            page = r.read().decode()
        assert r.status == 200 and "<title>lmcache-tpu chat</title>" in page
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            assert r.status == 200
        req = urllib.request.Request(
            url + "/v1/completions", method="POST",
            data=json.dumps({"prompt": "the quick brown fox",
                             "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["usage"]["completion_tokens"] == 4
        assert body["choices"][0]["text"]
    finally:
        proxy.shutdown()
        proxy.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def server_url():
    """One cache server for the examples that take a running one."""
    with cache_server() as url:
        yield url


def test_share_across_instances_decodes_the_same_tokens(server_url):
    out = share.main("cpu", server_url)
    assert out["cached_prefix_len"] == [0, share.CHUNK]
    assert out["tokens"][0] == out["tokens"][1]


def test_disaggregated_prefill_decodes_one_instances_tokens(server_url):
    out = disaggregated_prefill.main("cpu", server_url)
    assert out["cached_prefix_len"] == disaggregated_prefill.SEGMENT
    assert out["tokens"] == out["reference"]
    assert len(out["tokens"]) == disaggregated_prefill.NEW


def test_storage_backends_round_trip(server_url):
    out = round_trip.main("cpu", server_url)
    assert sorted(out) == [os.path.basename(p) for p in PORT_GALLERY]
    for name, r in out.items():
        assert r["hit"] == round_trip.TOKENS, name
        if name == "hybrid_cachegen.yaml":
            assert not r["exact"] and r["psnr_db"] >= round_trip.PSNR_DB
        else:
            assert r["exact"], name


@pytest.mark.parametrize("path", PORT_GALLERY, ids=os.path.basename)
def test_gallery_loads_as_the_jax_gallery(path):
    """Each of the port's YAML files gives the JAX file's values through
    JAX ``from_file`` ("cuda" where the JAX file says "tpu"; the disk tier
    in a directory of its own)."""
    name = os.path.basename(path)
    want = jpkg.LMCacheEngineConfig.from_file(
        os.path.join(JAX_GALLERY, name))
    mine_in_jax = jpkg.LMCacheEngineConfig.from_file(path)
    got = LMCacheEngineConfig.from_file(path)
    for field in CONFIG_FIELDS:
        assert getattr(mine_in_jax, field) == getattr(want, field), field
        assert getattr(got, field) == getattr(want, field), field
    if want.local_device in (None, "cpu"):
        assert got.local_device == mine_in_jax.local_device == (
            want.local_device)
    elif want.local_device == "tpu":
        assert got.local_device == "cuda"
    else:
        assert got.local_device == mine_in_jax.local_device != (
            want.local_device)


def test_rag_blend_beats_naive_reuse():
    out = rag_blend.main("cpu")
    assert out["misses"] == 1
    assert out["recomputed_tokens"] == int(np.ceil(
        rag_blend.RATIO * out["total_tokens"]))
    assert out["rel_l2"] < out["rel_l2_naive"]


def test_speculative_decode_is_greedy_in_fewer_steps():
    out = speculative_decode.main("cpu")
    assert len(out["tokens"]) == 48
    assert out["accepted"] > 0
    assert out["steps_spec"] < out["steps_plain"]


def test_mla_latent_cache_reuses_the_latents():
    out = mla_latent_cache.main("cpu")
    assert out["cached_prefix_len"] == 2 * mla_latent_cache.CHUNK
    assert out["tokens"][0] == out["tokens"][1]
    assert out["bytes_ratio"] == pytest.approx(2 * 8 * 128 / 80)
